"""The GKN system under test: the port's Darcy data path
(``prepare_darcy``, ``darcy_gkn_graphs``), model config, task, Adam and
``make_train_step``, fed the benchmark's fields and weights."""
from __future__ import annotations

from .. import cost, weights


def weight_specs(cfg: dict) -> list:
    w = cfg["width"]
    return (weights.linear("fc1", cfg["in_width"], w)
            + weights.dense("kernel", cfg["kernel_layers"])
            + [("root", (w, w), w ** -0.5), ("bias", (w,), w ** -0.5)]
            + weights.linear("fc2", w, cfg["out_width"]))


def program_tree(cfg: dict, w: dict) -> dict:
    """The port's parameter tree over the tensors of ``w``."""
    lin = lambda name: {"w": w[f"{name}.w"], "b": w[f"{name}.b"]}
    n = len(cfg["kernel_layers"]) - 1
    return {"fc1": lin("fc1"),
            "kernel": tuple(lin(f"kernel.{j}") for j in range(n)),
            "root": w["root"], "bias": w["bias"], "fc2": lin("fc2")}


def model_config(cfg: dict):
    from graph_pde_tpu_torch.models import GKNConfig

    return GKNConfig(
        width=cfg["width"], ker_width=cfg["ker_width"], depth=cfg["depth"],
        ker_in=cfg["ker_in"], in_width=cfg["in_width"],
        out_width=cfg["out_width"],
        kernel_layers=tuple(cfg["kernel_layers"]),
        relu_last=cfg["relu_last"], impl=cfg["impl"],
        compute_dtype=cfg["compute_dtype"])


def kernel_sources(cfg: dict) -> tuple:
    """The CUDA sources this configuration's training step launches
    (impl 'auto' on the card: K1 and B1-bwd)."""
    if cfg["impl"] in ("auto", "pallas"):
        return ("fused_edge_conv", "fused_edge_conv_bwd")
    return ()


class Training:
    """The stacked training samples on the device, their task and the
    useful work of each sample's step."""

    def __init__(self, cfg: dict, fields: dict, traffic: dict, device):
        from graph_pde_tpu_torch.data import darcy_gkn_graphs, prepare_darcy
        from graph_pde_tpu_torch.data.datasets import map_arrays
        from graph_pde_tpu_torch.train import GKNTask
        from graph_pde_tpu_torch.train.trainer import to_device

        n = fields["coeff"].shape[0]
        arrays, _ = prepare_darcy(fields, n=n, r=cfg["downsample"],
                                  u_norm=cfg["u_norm"])
        graphs = darcy_gkn_graphs(arrays, m=None, radius=cfg["radius"],
                                  node_block=cfg["node_block"])
        self.task = GKNTask(model_config(cfg),
                            u_normalizer=arrays.u_normalizer,
                            loss_type=cfg["loss"],
                            use_sample_idx=cfg["u_norm"] == "unit")
        data = to_device(graphs, device)
        self.batches = [map_arrays(lambda a, j=j: a[j:j + 1], data)
                        for j in range(n)]
        nodes = [int(v) for v in graphs.n_node]
        edges = [int(v) for v in graphs.n_edge]
        self.shapes = {"nodes": nodes[0], "edges": edges[0],
                       "kernel_layers": list(cfg["kernel_layers"]),
                       "width": cfg["width"],
                       "compute_dtype": cfg["compute_dtype"]}
        self.flops = [self._step_flops(cfg, nv, ev)
                      for nv, ev in zip(nodes, edges)]

    @staticmethod
    def _step_flops(cfg, n, e) -> dict:
        f = cost.gkn_forward_flops(cfg["in_width"], cfg["width"],
                                   cfg["kernel_layers"], cfg["depth"],
                                   cfg["out_width"], n, e)
        low = f["kappa"] + f["contraction"]
        # the backward counts twice the forward
        if cfg["compute_dtype"] == "bfloat16":
            return {"bf16": 3 * low, "f32": 3 * f["node"]}
        return {"bf16": 0.0, "f32": 3 * (low + f["node"])}
