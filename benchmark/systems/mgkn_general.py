"""The general-MGKN system under test: the port's Darcy data path
(``prepare_darcy``, ``darcy_mgkn_graphs``), model, task and trainer for
training; ``MGKNGeneralPredictor`` (``inference.py``) for requests."""
from __future__ import annotations

from .. import cost, weights


def _kw(cfg, level: int) -> int:
    return cfg["ker_width"] // 2 ** level


def weight_specs(cfg: dict) -> list:
    w, ki, levels = cfg["width"], cfg["ker_in"], len(cfg["points"])
    specs = weights.linear("fc_in", cfg["in_width"], w)
    for l in range(levels - 1):
        specs += weights.dense(f"conv_down.{l}.kernel",
                               [ki, _kw(cfg, l + 1), w * w])
    for l in range(levels):
        specs += weights.dense(f"conv_mid.{l}.kernel",
                               [ki, _kw(cfg, l), _kw(cfg, l), w * w])
        specs.append((f"conv_mid.{l}.root", (w, w), w ** -0.5))
    for l in range(levels - 1):
        specs += weights.dense(f"conv_up.{l}.kernel",
                               [ki, _kw(cfg, l + 1), w * w])
    return (specs + weights.linear("fc_out1", w, cfg["ker_width"])
            + weights.linear("fc_out2", cfg["ker_width"], cfg["out_width"]))


def program_tree(cfg: dict, w: dict) -> dict:
    """The port's parameter tree over the tensors of ``w``."""
    lin = lambda name: {"w": w[f"{name}.w"], "b": w[f"{name}.b"]}
    levels = len(cfg["points"])

    def kernel(name, n):
        return tuple(lin(f"{name}.kernel.{j}") for j in range(n))

    return {
        "fc_in": lin("fc_in"),
        "conv_down": [{"kernel": kernel(f"conv_down.{l}", 2)}
                      for l in range(levels - 1)],
        "conv_mid": [{"kernel": kernel(f"conv_mid.{l}", 3),
                      "root": w[f"conv_mid.{l}.root"]}
                     for l in range(levels)],
        "conv_up": [{"kernel": kernel(f"conv_up.{l}", 2)}
                    for l in range(levels - 1)],
        "fc_out1": lin("fc_out1"), "fc_out2": lin("fc_out2")}


def model_config(cfg: dict):
    from graph_pde_tpu_torch.models import MGKNGeneralConfig

    return MGKNGeneralConfig(
        width=cfg["width"], ker_width=cfg["ker_width"], depth=cfg["depth"],
        ker_in=cfg["ker_in"], in_width=cfg["in_width"],
        out_width=cfg["out_width"], points=tuple(cfg["points"]),
        variant=cfg["variant"], impl=cfg["impl"],
        compute_dtype=cfg["compute_dtype"])


def kernel_sources(cfg: dict) -> tuple:
    """impl 'kcached' launches no hand kernel; 'auto' on the card K1
    and B1-bwd."""
    if cfg["impl"] in ("auto", "pallas"):
        return ("fused_edge_conv", "fused_edge_conv_bwd")
    return ()


def _forward_flops(cfg, counts: dict) -> dict:
    f = cost.mgkn_forward_flops(cfg, counts)
    if cfg["compute_dtype"] == "bfloat16":
        raise ValueError("the MGKN FLOP count splits no bf16 share yet")
    return {"bf16": 0.0, "f32": f}


class Training:
    """The stacked multilevel training graphs on the device, their task
    and the useful work of each sample's step."""

    def __init__(self, cfg: dict, fields: dict, traffic: dict, device):
        from graph_pde_tpu_torch.data import darcy_mgkn_graphs, prepare_darcy
        from graph_pde_tpu_torch.data.datasets import map_arrays
        from graph_pde_tpu_torch.train import MGKNGeneralTask
        from graph_pde_tpu_torch.train.trainer import to_device

        n = fields["coeff"].shape[0]
        arrays, _ = prepare_darcy(fields, n=n, r=cfg["downsample"],
                                  u_norm=cfg["u_norm"])
        graphs, _ = darcy_mgkn_graphs(
            arrays, points=cfg["points"], radius_inner=cfg["radius_inner"],
            radius_inter=cfg["radius_inter"], k=1,
            seed=traffic["graph_seed"])
        self.task = MGKNGeneralTask(model_config(cfg),
                                    u_normalizer=arrays.u_normalizer,
                                    loss_type=cfg["loss"])
        data = to_device(graphs, device)
        self.batches = [map_arrays(lambda a, j=j: a[j:j + 1], data)
                        for j in range(n)]
        self.flops = []
        for j in range(n):
            counts = {
                kind: [int(getattr(graphs, f"{kind}_mask")[j, a:b].sum())
                       for a, b in getattr(graphs, f"{kind}_ranges")]
                for kind in ("mid", "down", "up")}
            fwd = _forward_flops(cfg, counts)
            # the backward counts twice the forward
            self.flops.append({k: 3 * v for k, v in fwd.items()})
        self.shapes = {}


class Serving:
    """The predictor of seeded weights, with normalizers fitted on the
    traffic's fields."""

    def __init__(self, cfg: dict, fields: dict, traffic: dict, w: dict,
                 device):
        from graph_pde_tpu_torch.data import prepare_darcy
        from graph_pde_tpu_torch.inference import MGKNGeneralPredictor

        arrays, norms = prepare_darcy(fields, n=fields["coeff"].shape[0],
                                      r=cfg["downsample"],
                                      u_norm=cfg["u_norm"])
        self.predictor = MGKNGeneralPredictor(
            program_tree(cfg, w), model_config(cfg), norms,
            arrays.u_normalizer, tuple(cfg["radius_inner"]),
            tuple(cfg["radius_inter"]), seed=traffic["splitter_seed"],
            device=device)

    def predict(self, coeff):
        """One request: a [s, s] coefficient field -> [s * s]."""
        return self.predictor.predict(coeff[None])[0]

    @staticmethod
    def forward_flops(cfg: dict, window_counts: list) -> dict:
        out = {"bf16": 0.0, "f32": 0.0}
        for counts in window_counts:
            for k, v in _forward_flops(cfg, counts).items():
                out[k] += v
        return out
