"""Port parity: GKNPredictor of graph_pde_tpu_torch against
graph_pde_tpu's, on the CPU, from the same parameters and normalizer
state, on the full-graph path and the split path.

Tolerance: decoded predictions agree to 1e-4 relative to their max-abs,
after re-encoding with the u-normalizer (the decoded field carries the
normalizer's mean, which would hide differences of the model output)."""
import jax
import numpy as np
import pytest
import torch

from graph_pde_tpu import inference as jinf
from graph_pde_tpu.data import darcy_dataset
from graph_pde_tpu.models import gkn as jgkn
from graph_pde_tpu.train.export import _normalizer_state
from graph_pde_tpu.utils import normalizers as jnorm

from graph_pde_tpu_torch import inference as tinf
from graph_pde_tpu_torch.convert import (gkn_params_from_numpy,
                                         normalizer_from_state)
from graph_pde_tpu_torch.models import gkn as tgkn
from graph_pde_tpu_torch.utils import normalizers as tnorm

PRED_TOL = 1e-4
S = 9


@pytest.fixture(scope="module")
def fields():
    return darcy_dataset(4, S, seed=0)


def _norms(fields, unit_u=False):
    flat = {k: v.reshape(v.shape[0], -1) for k, v in fields.items()}
    j_in = {"a": jnorm.GaussianNormalizer(flat["coeff"]),
            "a_smooth": jnorm.GaussianNormalizer(flat["Kcoeff"]),
            "a_gradx": jnorm.GaussianNormalizer(flat["Kcoeff_x"]),
            "a_grady": jnorm.GaussianNormalizer(flat["Kcoeff_y"])}
    ucls = (jnorm.UnitGaussianNormalizer if unit_u
            else jnorm.GaussianNormalizer)
    j_u = ucls(flat["sol"])
    t_in = {k: normalizer_from_state(_normalizer_state(v))
            for k, v in j_in.items()}
    return j_in, j_u, t_in, normalizer_from_state(_normalizer_state(j_u))


def _predictors(fields, impl, fused="off", unit_u=False, **kw):
    base = dict(width=16, ker_width=32, depth=2, ker_in=6, in_width=6,
                kernel_layers=(6, 16, 32, 256), relu_last=False, impl=impl,
                kcached_fused=fused)
    jcfg, tcfg = jgkn.GKNConfig(**base), tgkn.GKNConfig(**base)
    jp = jgkn.gkn_init(jax.random.PRNGKey(0), jcfg)
    tp = gkn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    j_in, j_u, t_in, t_u = _norms(fields, unit_u)
    jpred = jinf.GKNPredictor(params=jp, cfg=jcfg, input_normalizers=j_in,
                              u_normalizer=j_u, radius=0.3, **kw)
    tpred = tinf.GKNPredictor(params=tp, cfg=tcfg, input_normalizers=t_in,
                              u_normalizer=t_u, radius=0.3, device="cpu",
                              **kw)
    return jpred, tpred


def _close(got, want, u_norm):
    got, want = (u_norm.encode(v).numpy() for v in (got, want))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= PRED_TOL, f"relative max-abs error {err:.3g}"


@pytest.mark.parametrize("impl,fused", [("auto", "off"), ("kcached", "on")])
def test_predictor_full_path_matches(fields, impl, fused):
    jpred, tpred = _predictors(fields, impl, fused)
    args = [fields[k][:2] for k in ("coeff", "Kcoeff", "Kcoeff_x",
                                    "Kcoeff_y")]
    got, want = tpred.predict(*args), jpred.predict(*args)
    assert got.shape == (2, S * S)
    _close(got, want, tpred.u_normalizer)
    # auxiliary fields derived when missing
    _close(tpred.predict(fields["coeff"][2:]),
           jpred.predict(fields["coeff"][2:]), tpred.u_normalizer)


@pytest.mark.parametrize("impl,fused", [("reference", "off"),
                                        ("kcached", "on")])
def test_predictor_split_path_matches(fields, impl, fused):
    """Split/assemble forced by a lowered threshold: 81 nodes in shards
    of _largest_divisor_leq(81, 30) = 27."""
    jpred, tpred = _predictors(fields, impl, fused, split_threshold=10,
                               split_m=30)
    got = tpred.predict(fields["coeff"][:2])
    want = jpred.predict(fields["coeff"][:2])
    assert got.shape == (2, S * S) and np.isfinite(got).all()
    _close(got, want, tpred.u_normalizer)


def test_predictor_unit_u_normalizer_resolution_check(fields):
    jpred, tpred = _predictors(fields, "reference", unit_u=True)
    _close(tpred.predict(fields["coeff"][:1]),
           jpred.predict(fields["coeff"][:1]), tpred.u_normalizer)
    coarse = darcy_dataset(1, 7, seed=1)["coeff"]
    with pytest.raises(ValueError, match="per-node stats"):
        tpred.predict(coarse)


def test_decode_falls_back_like_jax():
    """RangeNormalizer.decode takes no sample_idx (TypeError fallback);
    a Unit normalizer gathers its stats at sample_idx."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(6, 20)).astype(np.float32)
    vals = rng.normal(size=(2, 20)).astype(np.float32)
    idx = np.stack([rng.permutation(20), rng.permutation(20)])
    for jn, tn in [(jnorm.RangeNormalizer(data), tnorm.RangeNormalizer(data)),
                   (jnorm.UnitGaussianNormalizer(data),
                    tnorm.UnitGaussianNormalizer(data))]:
        jp = jinf.GKNPredictor.__new__(jinf.GKNPredictor)
        tp = tinf.GKNPredictor.__new__(tinf.GKNPredictor)
        jp.u_normalizer, tp.u_normalizer = jn, tn
        np.testing.assert_allclose(tp._decode(vals, idx),
                                   jp._decode(vals, idx), rtol=1e-6,
                                   atol=1e-6)


def test_derive_aux_fields_and_divisor_match(fields):
    c = fields["coeff"][:2]
    for a, b in zip(tinf.derive_aux_fields(c, None, None, None, S),
                    jinf.derive_aux_fields(c, None, None, None, S)):
        np.testing.assert_array_equal(a, b)
    for n, m in [(58081, 400), (81, 30), (3721, 100), (17, 5)]:
        assert tinf._largest_divisor_leq(n, m) == \
            jinf._largest_divisor_leq(n, m)
    assert tinf._largest_divisor_leq(241 * 241, 400) == 241


def test_predictor_without_device_raises_without_cuda(monkeypatch, fields):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, t_in, t_u = _norms(fields)
    cfg = tgkn.GKNConfig(width=8, ker_width=16, depth=1)
    p = tgkn.gkn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.GKNPredictor(params=p, cfg=cfg, input_normalizers=t_in,
                          u_normalizer=t_u)
