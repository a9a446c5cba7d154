"""Command-line interface: one subcommand per workload.

Counterpart of ``onmf_ontf_ndl_tpu/cli.py``: the same subcommands
(``image``, ``tensor``, ``ising``, ``network``, ``video``), a flag per field
of the workload's config (``utils/config.py``), ``--out-dir`` and
``--no-recons``; each run trains, reconstructs unless told not to, and
writes the same artifacts and ``run.json``. ``--device`` (the config's
field) picks the card (``cuda``, the default) or the CPU (``cpu``).

Examples:
  python -m onmf_ontf_ndl_tpu_torch.cli image --path img.jpg \\
      --n-components 25 --iterations 100 --patch-size 10 --out-dir out/
  python -m onmf_ontf_ndl_tpu_torch.cli network --source edges.txt --k2 20 \\
      --mcmc-iterations 50 --recons-iter 5000
  python -m onmf_ontf_ndl_tpu_torch.cli ising --lattice-size 200 \\
      --temperature 5 --device cpu

``--distributed`` (with ``--coordinator-address``, ``--num-processes`` and
``--process-id``, or the ``env://`` variables of ``torchrun``) joins a
``torch.distributed`` process group first (``parallel/multihost.py``). The
subcommands are one-process pipelines: every process runs the workload,
and a process of rank r > 0 writes under ``<out-dir>/proc<r>``.

Where matplotlib is not installed, ``dict.png`` cannot be drawn: the
dictionary is saved as ``dict.npy`` instead and ``run.json`` says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from onmf_ontf_ndl_tpu_torch.utils.viz import _host

_UNSET = object()  # distinguishes "flag not given" from an explicit value


def _parse_bool(v: str) -> bool:
    """Strict bool flag parser: a typo must error, not silently read as
    False."""
    low = v.lower()
    if low in ("1", "true", "yes"):
        return True
    if low in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected one of 1/0/true/false/yes/no, got {v!r}")


def _add_fields(p: argparse.ArgumentParser, cfg_cls):
    for f in dataclasses.fields(cfg_cls):
        # dest is the exact field name (the flag --mcmc-iterations maps
        # onto MCMC_iterations); the default is a sentinel so that an
        # explicit "none" is honoured
        flag = "--" + f.name.replace("_", "-").lower()
        kw = {"dest": f.name, "default": _UNSET}
        if f.default is dataclasses.MISSING:
            kw["required"] = True
        if f.type in ("bool", bool):
            p.add_argument(flag, type=_parse_bool, **kw)
        elif f.type in ("int", int):
            p.add_argument(flag, type=int, **kw)
        elif f.type in ("float", float):
            p.add_argument(flag, type=float, **kw)
        elif f.type in ("float | None", "int | None"):
            caster = float if "float" in str(f.type) else int
            p.add_argument(flag,
                           type=lambda s, c=caster: None if s == "none" else c(s),
                           **kw)
        else:
            p.add_argument(flag, type=str, **kw)


def _build_cfg(cfg_cls, args):
    kw = {}
    for f in dataclasses.fields(cfg_cls):
        v = getattr(args, f.name, _UNSET)
        if v is not _UNSET:
            kw[f.name] = v
    return cfg_cls(**kw)


def _save_dictionary(meta: dict, out_dir: str, W, draw) -> None:
    """``dict.png`` through ``draw(save_path)``; without matplotlib the
    dictionary goes to ``dict.npy`` and ``run.json`` records why."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        np.save(f"{out_dir}/dict.npy", _host(W))
        meta["dict_png"] = "matplotlib not installed"
        print("onmf-ontf-ndl-tpu-torch: matplotlib not installed; the "
              f"dictionary is saved as {out_dir}/dict.npy", file=sys.stderr)
        return
    draw(save_path=f"{out_dir}/dict.png")


def _parser(specs: dict) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="onmf-ontf-ndl-tpu-torch",
        description="Online NMF/NTF and network dictionary learning on an "
                    "NVIDIA GPU (PyTorch/CUDA)")
    parser.add_argument("--out-dir", default="out")
    parser.add_argument("--distributed", action="store_true",
                        help="join a torch.distributed process group "
                             "before the run")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of rank 0's rendezvous")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, cls in specs.items():
        p = sub.add_parser(name)
        # SUPPRESS so a top-level --out-dir isn't clobbered by the
        # subparser default
        p.add_argument("--out-dir", default=argparse.SUPPRESS)
        p.add_argument("--no-recons", action="store_true")
        _add_fields(p, cls)
    return parser


def main(argv=None):
    from onmf_ontf_ndl_tpu_torch.utils import config as cfgs
    from onmf_ontf_ndl_tpu_torch.utils import viz
    from onmf_ontf_ndl_tpu_torch.utils.checkpoint import save_state

    specs = {
        "image": cfgs.ImageConfig,
        "tensor": cfgs.TensorConfig,
        "ising": cfgs.IsingConfig,
        "network": cfgs.NetworkConfig,
        "video": cfgs.VideoConfig,
    }
    args = _parser(specs).parse_args(argv)
    cfg = _build_cfg(specs[args.cmd], args)
    joined = False
    if args.distributed or args.coordinator_address is not None:
        from onmf_ontf_ndl_tpu_torch.parallel import multihost

        joined = not multihost.is_initialized()
        multihost.initialize(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes, process_id=args.process_id,
            device=cfg.device)
        # every process runs the workload: ranks above 0 write their
        # artifacts apart instead of racing on shared files
        if multihost.process_index() != 0:
            args.out_dir = os.path.join(
                args.out_dir, f"proc{multihost.process_index()}")
    try:
        return _run(args, cfg, viz, save_state)
    finally:
        if joined:
            multihost.shutdown()


def _run(args, cfg, viz, save_state) -> int:
    out = args.out_dir
    os.makedirs(out, exist_ok=True)
    app = cfg.build()
    t0 = time.time()
    meta = {"cmd": args.cmd, "config": dataclasses.asdict(cfg)}

    if args.cmd == "image":
        W = app.train_dict()
        _save_dictionary(meta, out, W, lambda save_path: viz.display_dictionary(
            W, cfg.patch_size, is_color=cfg.is_color, save_path=save_path))
        if not args.no_recons:
            if cfg.is_color:
                rec = app.reconstruct_image_color(
                    recons_resolution=cfg.recons_resolution)
            else:
                rec = app.reconstruct_image()
            np.save(f"{out}/recons.npy", _host(rec))
        save_state(f"{out}/state.npz", app.state)
    elif args.cmd == "tensor":
        W = app.train_dict(mode=cfg.mode, learn_joint_dict=cfg.learn_joint_dict)
        if cfg.learn_joint_dict and cfg.mode == 2:
            _save_dictionary(
                meta, out, W, lambda save_path: viz.display_dictionary(
                    W, cfg.patch_size, is_color=True, save_path=save_path))
        save_state(f"{out}/state.npz", app.state)
    elif args.cmd == "ising":
        _, dict_stack, errors = app.ising_mcmc_learning()
        np.save(f"{out}/dict_stack.npy", _host(dict_stack))
        np.save(f"{out}/errors.npy", _host(errors))
        _save_dictionary(meta, out, app.W, lambda save_path:
                         viz.display_dictionary(app.W, cfg.patch_size,
                                                is_color=False,
                                                save_path=save_path))
        save_state(f"{out}/state.npz", app.state)
        meta["final_surrogate_error"] = float(errors[-1])
    elif args.cmd == "network":
        app.train_dict()
        k = cfg.k1 + cfg.k2 + 1
        _save_dictionary(meta, out, app.W, lambda save_path:
                         viz.display_network_dictionary(app.W, k,
                                                        save_path=save_path))
        save_state(f"{out}/state.npz", app.state)
        if not args.no_recons:
            recon = app.reconstruct_network(recons_iter=cfg.recons_iter,
                                            num_chains=cfg.recons_chains)
            acc = app.compute_recons_accuracy()
            if app.G_recons_edges is not None:
                # sparse (edge-array) form: an edge list, not a dense
                # adjacency
                app.write_edgelist(f"{out}/recons_edges.txt")
            else:
                np.save(f"{out}/recons_adj.npy", _host(recon))
            meta["recons_accuracy"] = acc
    elif args.cmd == "video":
        W = app.train_dict(epochs=cfg.epochs)
        _save_dictionary(meta, out, W, lambda save_path: viz.display_dictionary(
            W, cfg.patch_size, is_color=cfg.is_color, save_path=save_path))
        save_state(f"{out}/state.npz", app.state)

    meta["wall_seconds"] = round(time.time() - t0, 2)
    with open(f"{out}/run.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
