"""Command-line interface (counterpart of graph_pde_tpu/cli.py).

Usage:
    python -m graph_pde_tpu_torch.cli list
    python -m graph_pde_tpu_torch.cli run <experiment> [--smoke]
        [--set key=value ...] [--out results.json] [--bundle DIR]
        [--figures DIR] [--profile DIR] [--curves DIR]
        [--expect-l2 X [--metric M] [--tol T]] [--device {cuda,cpu}]
    python -m graph_pde_tpu_torch.cli sweep <experiment> [--smoke]
        [--axis key=[v1,v2,...]] [--out results.json] [--device ...]
    python -m graph_pde_tpu_torch.cli predict <bundle_dir>
        (--input fields.mat | --synthetic N [--res S]) [--n N]
        [--output pred.mat] [--truth-field sol] [--device ...]

One entry point over the experiment registry. ``run --bundle`` exports
a serving bundle (train/export.py) and ``predict`` serves it: a GKN
bundle on new Darcy coefficient fields at any grid resolution
(GKNPredictor), a general-MGKN bundle on Darcy fields through the
reference's split-assemble protocol (MGKNGeneralPredictor), an
orthogonal-MGKN bundle on Burgers initial conditions 'a' at its
training resolution (MGKNOrthogonalPredictor). A GCN run exports no
bundle and a GCN bundle has no serving path, as in the JAX package; both
exit 2. ``run --figures`` writes the worst, median and best test
samples' triptychs (GKN and MGKN runs). Every command runs on CUDA
unless ``--device cpu`` asks for the CPU; without a GPU it raises. The
JSON summary lines are the JAX CLI's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _parse_override(kv: str):
    key, val = kv.split("=", 1)
    try:
        parsed = json.loads(val)
    except json.JSONDecodeError:
        parsed = val
    if isinstance(parsed, list):
        parsed = tuple(parsed)
    return key, parsed


def _read_darcy_input(args):
    """(coeff, Kcoeff, Kcoeff_x, Kcoeff_y, truth) from --input or
    --synthetic; an auxiliary field absent from the file is None (the
    predictor derives it)."""
    if not args.input:
        from .data import load_or_generate_darcy

        f = load_or_generate_darcy(args.synthetic, args.res)
        return (f["coeff"], f["Kcoeff"], f["Kcoeff_x"], f["Kcoeff_y"],
                f["sol"])
    from .utils.matio import MatReader

    reader = MatReader(args.input)
    have = set(reader.keys())
    aux = [reader.read_field(k) if k in have else None
           for k in ("Kcoeff", "Kcoeff_x", "Kcoeff_y")]
    truth = reader.read_field(args.truth_field) if args.truth_field \
        else None
    return (reader.read_field("coeff"), *aux, truth)


def _predict_darcy(args, params, mcfg, norms, extra, device):
    """Darcy serving: coefficient fields in, decoded solution fields out,
    at any resolution; GKN on one graph or shards, the general MGKN
    through the split-assemble protocol (MGKN_general_darcy2d.py:
    306-333)."""
    from .inference import GKNPredictor, MGKNGeneralPredictor

    general = extra.get("family") == "mgkn_general"
    if args.res is None:
        # a general-MGKN bundle's unit u-normalizer serves only its
        # training grid
        args.res = int(extra.get("train_s", 61)) if general else 61
    coeff, kcoeff, kx, ky, truth = _read_darcy_input(args)
    if args.n:
        coeff, kcoeff, kx, ky, truth = (
            None if a is None else a[: args.n]
            for a in (coeff, kcoeff, kx, ky, truth))
    input_norms = {k: norms[k] for k in
                   ("a", "a_smooth", "a_gradx", "a_grady")}
    if general:
        predictor = MGKNGeneralPredictor(
            params, mcfg, input_normalizers=input_norms,
            u_normalizer=norms["u"],
            radius_inner=tuple(extra["radius_inner"]),
            radius_inter=tuple(extra["radius_inter"]), device=device)
    else:
        predictor = GKNPredictor(
            params, mcfg, input_normalizers=input_norms,
            u_normalizer=norms["u"], radius=float(extra.get("radius", 0.2)),
            device=device)
    t0 = time.perf_counter()
    pred = predictor.predict(coeff, kcoeff, kx, ky)
    dt = time.perf_counter() - t0
    n, s = coeff.shape[0], coeff.shape[1]
    summary = {"n": n, "s": s, "wall_time_s": round(dt, 3),
               "per_sample_ms": round(1000 * dt / n, 2)}
    if truth is not None:
        from .utils.losses import LpLoss

        rel = LpLoss(size_average=True).rel(
            pred.reshape(n, -1), np.asarray(truth).reshape(n, -1))
        summary["rel_l2"] = round(float(rel), 6)
    if args.output:
        from .utils.matio import write_mat

        write_mat(args.output, {"pred": pred.reshape(n, s, s)})
        summary["output"] = args.output
    print(json.dumps(summary))
    return 0


def _predict_burgers_orthogonal(args, params, mcfg, norms, extra, device):
    """Orthogonal-MGKN serving: Burgers initial conditions 'a' [n, s] in
    (at the bundle's training s, or a multiple of it, stride-downsampled
    as the reference reads its 2^13 fields), decoded solutions out."""
    from .inference import MGKNOrthogonalPredictor

    truth = None
    if args.input:
        from .utils.matio import MatReader

        reader = MatReader(args.input)
        a = reader.read_field("a")
        if args.truth_field:
            truth = reader.read_field(args.truth_field)
    else:
        from .data import load_or_generate_burgers

        fields = load_or_generate_burgers(args.synthetic, mcfg.s)
        a, truth = fields["a"], fields["u"]
    if args.n:
        a = a[: args.n]
        truth = None if truth is None else truth[: args.n]
    if a.shape[1] != mcfg.s and a.shape[1] % mcfg.s == 0:
        a = a[:, :: a.shape[1] // mcfg.s]
        truth = None if truth is None else \
            truth[:, :: truth.shape[1] // mcfg.s]
    predictor = MGKNOrthogonalPredictor(
        params, mcfg, a_normalizer=norms["a"], u_normalizer=norms["u"],
        device=device)
    t0 = time.perf_counter()
    pred = predictor.predict(a)
    dt = time.perf_counter() - t0
    n, s = pred.shape
    summary = {"n": n, "s": s, "wall_time_s": round(dt, 3),
               "per_sample_ms": round(1000 * dt / n, 2)}
    if truth is not None:
        from .utils.losses import LpLoss

        rel = LpLoss(size_average=True).rel(pred, np.asarray(truth)[:, :s])
        summary["rel_l2"] = round(float(rel), 6)
    if args.output:
        from .utils.matio import write_mat

        write_mat(args.output, {"pred": pred})
        summary["output"] = args.output
    print(json.dumps(summary))
    return 0


def _predict(args, device):
    """Serves a trained bundle on new input fields: GKN and the general
    MGKN on Darcy, the orthogonal MGKN on Burgers. Other bundles (GCN)
    exit 2."""
    from .train import load_bundle

    if not args.input and not args.synthetic:
        print("error: need --input or --synthetic", file=sys.stderr)
        return 2
    params, mcfg, norms, extra = load_bundle(args.bundle)
    family = extra.get("family", "gkn")
    dataset = extra.get("dataset", "darcy")
    if family == "mgkn_orthogonal":
        return _predict_burgers_orthogonal(args, params, mcfg, norms, extra,
                                           device)
    if family in ("gkn", "mgkn_general") and dataset == "darcy":
        return _predict_darcy(args, params, mcfg, norms, extra, device)
    print(f"error: no serving path for family={family!r} "
          f"dataset={dataset!r}", file=sys.stderr)
    return 2


def _sweep(args, device):
    from .experiments.sweeps import REFERENCE_SWEEPS, run_sweep

    axes = dict(_parse_override(kv) for kv in args.axis) or None
    if axes is None and args.experiment not in REFERENCE_SWEEPS:
        print(f"error: no reference sweep for {args.experiment!r}; "
              "pass --axis key=[v1,v2,...]", file=sys.stderr)
        return 2
    axes = {k: tuple(v) if isinstance(v, (list, tuple)) else (v,)
            for k, v in axes.items()} if axes else None
    results = run_sweep(args.experiment, axes, smoke=args.smoke,
                        device=device)
    for r in results:
        print(json.dumps({"swept": r["swept"],
                          "final_test_l2": r.get("final_test_l2"),
                          "full_field_l2": r.get("full_field_l2")},
                         default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, default=str)
    return 0


def _save_curves(out_dir: str, name: str, result) -> None:
    """Epoch-indexed train/test rel-L2 curves as .txt files."""
    os.makedirs(out_dir, exist_ok=True)
    train = np.stack([np.arange(1, len(result["train_l2"]) + 1, dtype=float),
                      np.asarray(result["train_l2"], float)], axis=1)
    np.savetxt(os.path.join(out_dir, f"{name}_train_l2.txt"), train,
               header="epoch rel_l2")
    if result.get("test_l2"):
        test = np.stack([
            np.asarray(result.get("test_epochs")
                       or range(1, len(result["test_l2"]) + 1), float),
            np.asarray(result["test_l2"], float)], axis=1)
        np.savetxt(os.path.join(out_dir, f"{name}_test_l2.txt"), test,
                   header="epoch rel_l2")
    print(f"curves -> {out_dir}")


def _check_expected(args, result) -> int:
    """--expect-l2: exit 0 when the chosen metric is within --tol of the
    expected value, 1 when not, 2 when the metric is missing."""
    try:
        if args.metric.startswith("multires:"):
            value = result["multires"][int(args.metric.split(":", 1)[1])]
        else:
            value = result[args.metric]
    except KeyError:
        have = sorted(k for k, v in result.items()
                      if isinstance(v, (int, float)) or k == "multires")
        print(f"error: --metric {args.metric!r} not in results; "
              f"available: {have}", file=sys.stderr)
        return 2
    if value is None:
        print(f"error: --metric {args.metric!r} is None for this "
              "config (no test data / eval protocol?)", file=sys.stderr)
        return 2
    dev = abs(float(value) - args.expect_l2)
    ok = dev <= args.tol
    print(f"parity {args.metric}={float(value):.6f} "
          f"expected={args.expect_l2:.6f} |dev|={dev:.2e} "
          f"tol={args.tol:.0e} -> {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def _run(args, device):
    from .experiments import get, run_experiment

    cfg = get(args.experiment)
    overrides = dict(_parse_override(kv) for kv in args.set)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    def progress(ep, params, train_l2, test_l2):
        msg = f"epoch {ep}: train_l2={train_l2:.5f}"
        if test_l2 is not None:
            msg += f" test_l2={test_l2:.5f}"
        print(msg, flush=True)

    t0 = time.perf_counter()
    result = run_experiment(cfg, smoke=args.smoke, progress=progress,
                            figures_dir=args.figures,
                            profile_dir=args.profile, device=device)
    bundle = result.pop("_bundle", None)
    if args.curves:
        _save_curves(args.curves, cfg.name, result)
    if args.bundle:
        if bundle is None:
            print(f"error: {cfg.family!r} runner exports no bundle",
                  file=sys.stderr)
            return 2
        from .train import save_bundle

        save_bundle(args.bundle, result["params"], bundle["model_cfg"],
                    normalizers=bundle["normalizers"],
                    extra=bundle["extra"])
        print(f"bundle -> {args.bundle}")
    result.pop("params")
    result["wall_time_s"] = time.perf_counter() - t0
    print(json.dumps({k: v for k, v in result.items()
                      if not isinstance(v, (list, dict))
                      or k in ("multires",)}, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, default=str)
    if args.expect_l2 is not None:
        return _check_expected(args, result)
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="graph_pde_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list registered experiments")

    def device_arg(sp):
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")

    runp = sub.add_parser("run", help="run an experiment")
    runp.add_argument("experiment", help="experiment name")
    runp.add_argument("--smoke", action="store_true",
                      help="seconds-scale version for verification")
    runp.add_argument("--set", action="append", default=[],
                      metavar="key=value", help="config override")
    runp.add_argument("--out", default=None, help="write results JSON")
    runp.add_argument("--expect-l2", type=float, default=None,
                      help="parity assertion: fail (exit 1) unless the "
                           "chosen metric is within --tol of this value")
    runp.add_argument("--metric", default="final_test_l2",
                      help="result key checked by --expect-l2 "
                           "(final_test_l2 | full_field_l2 | "
                           "multires:<s>)")
    runp.add_argument("--tol", type=float, default=1e-3,
                      help="tolerance for --expect-l2")
    runp.add_argument("--bundle", default=None, metavar="DIR",
                      help="export a serving bundle of the trained model")
    runp.add_argument("--figures", default=None, metavar="DIR",
                      help="save truth/approx/error triptychs for the "
                           "worst/median/best test samples (reference "
                           "parity: UAI1_full_resolution.py:335-461)")
    runp.add_argument("--profile", default=None, metavar="DIR",
                      help="capture a torch.profiler trace of the run")
    runp.add_argument("--curves", default=None, metavar="DIR",
                      help="save epoch-indexed train/test rel-L2 curve "
                           ".txt files")
    device_arg(runp)
    swp = sub.add_parser("sweep", help="run a parameter sweep (the "
                                       "reference scripts' for-loops)")
    swp.add_argument("experiment", help="experiment name")
    swp.add_argument("--smoke", action="store_true")
    swp.add_argument("--axis", action="append", default=[],
                     metavar="key=[v1,v2,...]",
                     help="sweep axis as JSON list (default: the "
                          "reference's own sweep for this experiment)")
    swp.add_argument("--out", default=None, help="write results JSON")
    device_arg(swp)
    predp = sub.add_parser("predict", help="serve a trained bundle on "
                                           "new coefficient fields")
    predp.add_argument("bundle", help="bundle dir from run --bundle")
    predp.add_argument("--input", default=None,
                       help=".mat with 'coeff' [n, s, s] (+ optional "
                            "Kcoeff/Kcoeff_x/Kcoeff_y; derived if absent)"
                            ", or 'a' [n, s] for an orthogonal-MGKN "
                            "bundle")
    predp.add_argument("--synthetic", type=int, default=0, metavar="N",
                       help="generate N synthetic fields (Darcy, or "
                            "Burgers for an orthogonal-MGKN bundle) "
                            "instead of --input")
    predp.add_argument("--res", type=int, default=None,
                       help="grid resolution for --synthetic Darcy "
                            "fields (default 61; a general-MGKN bundle: "
                            "its training s; Burgers: the bundle's s)")
    predp.add_argument("--n", type=int, default=None,
                       help="predict only the first N samples")
    predp.add_argument("--output", default=None,
                       help="write predictions ('pred' [n, s, s]) "
                            "as .mat")
    predp.add_argument("--truth-field", default=None, metavar="NAME",
                       help="field with ground truth in --input "
                            "(e.g. 'sol'): prints mean rel-L2")
    device_arg(predp)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "list":
        from .experiments import names

        for n in names():
            print(n)
        return 0
    from .device import resolve_device

    device = resolve_device(args.device)
    if args.cmd == "predict":
        return _predict(args, device)
    if args.cmd == "sweep":
        return _sweep(args, device)
    return _run(args, device)


if __name__ == "__main__":
    sys.exit(main())
