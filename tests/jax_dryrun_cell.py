"""JAX's per-device numbers of one dry-run cell, at a depth cut and a
grad_accum of the caller's: the JAX package's own dry-run code
(``repro.launch.dryrun.build_cell``, ``hlo_analysis.analyze``,
``memory_analysis``) compiled on the CPU's host devices.

``repro.launch.dryrun``'s command line has no depth cut, and a cut config
gets another grad_accum from ``pick_grad_accum`` than the full model; the
port's ``python -m repro_torch.launch.dryrun --layers N --grad-accum A``
traces the same cell. ``chip_smoke.py``'s ``JAX_DRYRUN_MULTI_POD_*`` come
from:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_dryrun_cell.py \\
        llama4-scout-17b-a16e train_4k --multi-pod --layers 2 --grad-accum 16
"""
import argparse
import dataclasses
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    args = ap.parse_args()
    n = 512 if args.multi_pod else 256
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    from repro.configs import SHAPES, get_config
    from repro.launch import hlo_analysis
    from repro.launch.dryrun import build_cell
    from repro.launch.mesh import make_production_mesh
    from repro.optim.adamw import OptConfig
    from repro.runtime.train import TrainRunConfig
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    trc = (None if args.grad_accum is None
           else TrainRunConfig(opt=OptConfig(), grad_accum=args.grad_accum))
    jitted, kwargs = build_cell(cfg, SHAPES[args.shape],
                                make_production_mesh(multi_pod=args.multi_pod), trc=trc)
    compiled = jitted.lower(*kwargs.values()).compile()
    mem = compiled.memory_analysis()
    print(json.dumps({"arch": args.arch, "shape": args.shape, "layers": cfg.n_layers,
                      "grad_accum": args.grad_accum, "multi_pod": args.multi_pod,
                      "flops": hlo_analysis.analyze(compiled.as_text()).flops,
                      "temp_bytes": mem.temp_size_in_bytes,
                      "argument_bytes": mem.argument_size_in_bytes}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    main()
