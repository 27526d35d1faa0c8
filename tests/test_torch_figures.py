"""Port parity, the run figures: the triptych writers of
graph_pde_tpu_torch.train.metrics, and the runner's choice of the worst,
median and best test samples (``_emit_run_figures``) against
graph_pde_tpu's on the same parameters and test data, on the CPU.

Both packages' writers are replaced by recorders, so the comparison sees
what each runner would draw: the file names, the titles (with each
sample's decoded rel-L2), the coordinates, truth and prediction. A full
grid (GCN on an s=8 lattice) takes the field triptych, a Nystrom
subsample (GKN, m=30 of an s=17 grid) the scattered one."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_pde_tpu.data import datasets as jdata
from graph_pde_tpu.experiments import runners as jrun
from graph_pde_tpu.graph import graph as jgraph
from graph_pde_tpu.models import gcn as jgcn
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.train import metrics as jmetrics
from graph_pde_tpu.train import tasks as jtasks
from graph_pde_tpu.utils import normalizers as jnorm

from graph_pde_tpu_torch.convert import (gcn_params_from_numpy,
                                         gkn_params_from_numpy)
from graph_pde_tpu_torch.data import datasets as tdata
from graph_pde_tpu_torch.data import synthetic as tsyn
from graph_pde_tpu_torch.experiments import runners as trun
from graph_pde_tpu_torch.graph import NodeBatch, build_graph, grid_edge
from graph_pde_tpu_torch.models import gcn as tgcn
from graph_pde_tpu_torch.models import gkn as tgkn
from graph_pde_tpu_torch.train import GCNTask, GKNTask
from graph_pde_tpu_torch.train import metrics as tmetrics
from graph_pde_tpu_torch.utils import normalizers as tnorm

MODEL_TOL = 1e-4
HAVE_MPL = importlib.util.find_spec("matplotlib") is not None


class _Cfg:
    name = "fig"


@pytest.mark.parametrize("kind", ["field", "points", "line"])
def test_triptych_writers_write_pngs(tmp_path, kind):
    """Each writer creates its directory and writes a PNG, or returns
    None where matplotlib cannot be imported (as the JAX package's)."""
    rng = np.random.default_rng(0)
    truth = rng.normal(size=(64,))
    approx = truth + 0.1
    path = str(tmp_path / "img" / f"{kind}.png")
    if kind == "field":
        out = tmetrics.save_field_triptych(truth, approx, path, "t")
    elif kind == "points":
        out = tmetrics.save_points_triptych(rng.uniform(size=(64, 2)),
                                            truth, approx, path, "t")
    else:
        out = tmetrics.save_line_triptych(np.linspace(0, 1, 64), truth,
                                          approx, path)
    if HAVE_MPL:
        assert out == path and os.path.getsize(path) > 0
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    else:
        assert out is None and not os.path.exists(path)


def _recorders(monkeypatch, module) -> list:
    """Replaces ``module``'s three writers by recorders of (kind, file
    name, title, arrays); returns the record list."""
    calls = []
    for kind in ("field", "points", "line"):
        def record(*args, kind=kind):
            *arrays, path, title = args
            calls.append((kind, os.path.basename(path), title,
                          [np.asarray(a, np.float64) for a in arrays]))
            return path
        monkeypatch.setattr(module, f"save_{kind}_triptych", record)
    return calls


def _same_picks(got, want):
    """The same writers, files and samples (truth equal), predictions
    within MODEL_TOL of their max-abs, rel-L2s within 1e-4 relative."""
    assert [c[:2] for c in got] == [c[:2] for c in want]
    assert [c[1] for c in got] == ["fig_best.png", "fig_median.png",
                                   "fig_worst.png"]
    for (_, _, tt, ta), (_, _, jt, ja) in zip(got, want):
        assert tt.split(" rel-L2=")[0] == jt.split(" rel-L2=")[0]
        assert float(tt.split("=")[-1]) == pytest.approx(
            float(jt.split("=")[-1]), rel=1e-4, abs=1e-4)
        for a, b in zip(ta[:-1], ja[:-1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        err = np.abs(ta[-1] - ja[-1]).max() / np.abs(ja[-1]).max()
        assert err <= MODEL_TOL
    # three different samples
    assert len({c[3][-2].tobytes() for c in got}) == 3


def test_picks_match_jax_full_grid(monkeypatch, tmp_path):
    """GCN on a shared lattice template, five test samples: field
    triptychs of the same worst, median and best samples as JAX's."""
    s, count = 8, 5
    n = s * s
    _, ei, _ = grid_edge(s, s)
    args = (np.zeros((n, 6), np.float32), ei[0], ei[1],
            np.zeros((ei.shape[1], 1), np.float32))
    ttpl = build_graph(*args, node_block=16)
    jtpl = jax.tree.map(jnp.asarray, jgraph.build_graph(*args,
                                                        node_block=16))
    n_pad = ttpl.num_nodes_padded
    rng = np.random.default_rng(5)
    xs = np.zeros((count, n_pad, 6), np.float32)
    ys = np.zeros((count, n_pad, 1), np.float32)
    xs[:, :n] = rng.normal(size=(count, n, 6))
    ys[:, :n, 0] = rng.normal(size=(count, n)) * np.arange(1, count + 1)[
        :, None]
    nn = np.full((count,), n, np.int32)
    u = rng.normal(size=(4, n_pad)).astype(np.float32) + 3.0
    cfg = dict(width=8, ker_width=16, depth=2, in_width=6)
    jp = jgcn.gcn_init(jax.random.PRNGKey(0), jgcn.GCNConfig(**cfg))
    tp = gcn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ttask = GCNTask(tgcn.GCNConfig(**cfg),
                    u_normalizer=tnorm.UnitGaussianNormalizer(u),
                    use_sample_idx=False, template=ttpl.to("cpu"))
    jtask = jtasks.GCNTask(jgcn.GCNConfig(**cfg),
                           u_normalizer=jnorm.UnitGaussianNormalizer(u),
                           use_sample_idx=False, template=jtpl)
    got, want = (_recorders(monkeypatch, tmetrics),
                 _recorders(monkeypatch, jmetrics))
    tout = trun._emit_run_figures(str(tmp_path / "t"), _Cfg, ttask, tp,
                                  NodeBatch(x=xs, y=ys, n_node=nn), 2,
                                  "cpu")
    jout = jrun._emit_run_figures(
        str(tmp_path / "j"), _Cfg, jtask, jp,
        jgraph.NodeBatch(x=xs, y=ys, n_node=nn), 2)
    assert [os.path.basename(p) for p in tout] == \
        [os.path.basename(p) for p in jout]
    assert all(c[0] == "field" for c in got)
    _same_picks(got, want)


def test_picks_match_jax_nystrom(monkeypatch, tmp_path):
    """GKN on five Nystrom test graphs (per-node unit stats gathered at
    sample_idx): scatter triptychs of the same samples as JAX's."""
    fields = tsyn.darcy_dataset(5, 17, seed=4)
    ta, _ = tdata.prepare_darcy(fields, n=5)
    ja, _ = jdata.prepare_darcy(fields, n=5)
    for k in ("a", "a_smooth", "a_gradx", "a_grady", "u"):
        setattr(ja, k, getattr(ta, k))
    kw = dict(m=30, radius=0.3, seed=1)
    tg, jg = tdata.darcy_gkn_graphs(ta, **kw), jdata.darcy_gkn_graphs(ja,
                                                                      **kw)
    cfg = dict(width=8, ker_width=16, depth=2, ker_in=6, in_width=6,
               kernel_layers=(6, 8, 16, 64), relu_last=False,
               impl="kcached")
    jcfg = jgkn.GKNConfig(**cfg)
    jp = jgkn.gkn_init(jax.random.PRNGKey(1), jcfg)
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ttask = GKNTask(tgkn.GKNConfig(**cfg), u_normalizer=ta.u_normalizer)
    jtask = jtasks.GKNTask(jcfg, u_normalizer=ja.u_normalizer)
    got, want = (_recorders(monkeypatch, tmetrics),
                 _recorders(monkeypatch, jmetrics))
    trun._emit_run_figures(str(tmp_path / "t"), _Cfg, ttask, tp, tg, 2,
                           "cpu")
    jrun._emit_run_figures(str(tmp_path / "j"), _Cfg, jtask, jp, jg, 2)
    assert all(c[0] == "points" for c in got)
    _same_picks(got, want)
