"""MATLAB .mat reading and writing (counterpart of
graph_pde_tpu/utils/matio.py), host numpy.

Files before v7.3 go through ``scipy.io``. A v7.3 file is HDF5: reading
or writing one needs ``h5py``, imported only there (a missing h5py
raises an ImportError that names it). HDF5 stores MATLAB's column-major
arrays, so both directions reverse the axes.
"""
from __future__ import annotations

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as ex:
        raise ImportError(
            "reading or writing a v7.3 .mat file needs h5py, which is not "
            "installed; files before v7.3 need only scipy") from ex
    return h5py


def _reverse_axes(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, axes=range(x.ndim - 1, -1, -1))


class MatReader:
    """Reads fields of a .mat file as numpy arrays (float32 unless
    ``to_float`` is False)."""

    def __init__(self, file_path: str, to_float: bool = True):
        self.to_float = to_float
        self.file_path = file_path
        self._load_file()

    def _load_file(self) -> None:
        import scipy.io

        try:
            self.data = scipy.io.loadmat(self.file_path)
            self.old_mat = True
        except (NotImplementedError, ValueError):
            # scipy.io: NotImplementedError for a MATLAB v7.3 header,
            # ValueError for an HDF5 file without one (write_mat's)
            self.data = _h5py().File(self.file_path, "r")
            self.old_mat = False

    def load_file(self, file_path: str) -> None:
        self.file_path = file_path
        self._load_file()

    def keys(self):
        return [k for k in self.data.keys() if not k.startswith("__")]

    def read_field(self, field: str) -> np.ndarray:
        x = self.data[field]
        if not self.old_mat:
            x = _reverse_axes(x[()])
        x = np.asarray(x)
        return x.astype(np.float32) if self.to_float else x


def write_mat(file_path: str, fields: dict, v73: bool = False) -> None:
    """Writes ``fields`` (name -> array) as a .mat file that ``MatReader``
    reads back: v7.3 (HDF5, axes reversed) when ``v73``, else the format
    before it through ``scipy.io.savemat``."""
    if v73:
        with _h5py().File(file_path, "w") as f:
            for k, v in fields.items():
                f.create_dataset(k, data=_reverse_axes(np.asarray(v)))
        return
    import scipy.io

    scipy.io.savemat(file_path, {k: np.asarray(v) for k, v in fields.items()})


__all__ = ["MatReader", "write_mat"]
