"""Dry run: every (arch × shape) step built and counted on meta tensors —
the port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each step for 512 placeholder TPU
devices and reads the compiled program's memory and cost analyses. Here
the step runs on the ``meta`` device (shapes and dtypes, no data, no
card): ``build_step`` builds the reference's step for the shape's kind on
the port's entry points — ``train_step`` (``train.make_train_step``,
remat, the presets' microbatches), ``prefill_step`` (``forward(...,
collect_cache=True)``, returning the last position's logits and the
cache) or ``serve_step`` (``decode_step`` at the cache's last position) —
and ``run_one`` runs it once under ``roofline.op_cost.OpCounter``. The
report keeps the reference's fields where they mean the same on one card:
the roofline terms at the H100's data-sheet rates (``launch.mesh``), the
argument, output and temporary bytes and the peak from the count's
live-storage mark, ``fits_hbm`` against 80 GB. These are counts on meta
with data-sheet constants, not card times. Fields that meant TPU or XLA
things (the CPU f32-carry artifact, TPU-projected peaks, lowering and
compile times) are gone.

The mesh is the one card's, (1, 1). ``--multi-pod`` / ``--both-meshes``
report, for the reference's 16 x 16 and 2 x 16 x 16 meshes, only the
bytes one device holds of the sharded arguments (params, optimizer state,
caches, the batch) by the sharding tables: table arithmetic, with no
temporaries and no roofline.

``build_step(..., device="cuda")`` (the default of every other entry
point) builds the same step on the card with weights drawn from a seed,
``device="cpu"`` for the tests.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --out out.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import as_device, resolve_device
from repro_torch.launch import mesh as M
from repro_torch.launch.presets import (TRAIN_MICROBATCHES,
                                        TRAIN_REMAT_GROUP, config_for)
from repro_torch.launch.specs import (decode_state_shape, input_specs,
                                      params_shape)
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.pytree import leaves, tree_map
from repro_torch.roofline.analysis import roofline_terms
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.train import make_train_step

ONE_CARD = {"data": 1, "model": 1}
# the weights and inputs of a step built off meta
SEED = 0


class Step(NamedTuple):
    fn: Callable
    args: Tuple
    cfg: Any
    shape: ShapeConfig
    microbatches: int
    model_flops: float


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def _microbatches(arch: str, shape: ShapeConfig, mesh: Dict[str, int],
                  microbatches: Optional[int]) -> int:
    """The presets' microbatches, halved until each microbatch still
    splits over the mesh's data axes (the reference's loop)."""
    if shape.kind != "train":
        return 1
    nmb = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
    dsize = 1
    for a in ("pod", "data"):
        dsize *= mesh.get(a, 1)
    while nmb > 1 and (shape.global_batch // nmb) % dsize != 0:
        nmb //= 2
    return nmb


def _fill(tree: Any, device: torch.device, seed: int, vocab: int) -> Any:
    """Real tensors on ``device`` for a tree of meta stand-ins: integer
    leaves (token ids, labels) uniform below ``vocab``, float leaves
    N(0, 1), from one generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def one(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g, device=device,
                               dtype=torch.float32).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=g, device=device,
                             dtype=t.dtype)

    return tree_map(one, tree)


def build_step(arch: str, shape: Union[str, ShapeConfig], *,
               device="cuda", microbatches: Optional[int] = None,
               mesh: Optional[Dict[str, int]] = None,
               cfg_overrides: Optional[dict] = None) -> Step:
    """The reference's step for ``shape``'s kind and its arguments:
    ``train_step(params, opt_state, batch)``, ``prefill_step(params,
    batch)`` -> (logits[:, -1], cache) or ``serve_step(params, state,
    batch, pos)`` -> (logits, state). On ``device="meta"`` the arguments
    are ``launch.specs``' stand-ins; elsewhere params drawn from ``SEED``
    on the device (``init_params``), random inputs, a zero decode state.
    ``shape`` is an ``INPUT_SHAPES`` name or a ``ShapeConfig``."""
    sc = _shape(shape)
    cfg = config_for(arch, sc.name)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    mesh = mesh or ONE_CARD
    dev = as_device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    nmb = _microbatches(arch, sc, mesh, microbatches)
    if dev.type == "meta":
        params = params_shape(cfg)
    else:
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = input_specs(cfg, sc, microbatches=nmb)
    if dev.type != "meta":
        batch = _fill(batch, dev, SEED + 1, cfg.vocab_size)
    tokens = sc.global_batch * sc.seq_len
    if sc.kind == "train":
        step = make_train_step(cfg, num_microbatches=nmb,
                               remat_group=TRAIN_REMAT_GROUP.get(arch, 1))
        return Step(step, (params, adamw_init(params), batch), cfg, sc, nmb,
                    6.0 * cfg.active_param_count() * tokens)
    if sc.kind == "prefill":
        def prefill_step(params, batch):
            logits, _aux, (cache, _mask) = T.forward(
                params, batch, cfg, collect_cache=True)
            return logits[:, -1], cache

        return Step(prefill_step, (params, batch), cfg, sc, 1,
                    2.0 * cfg.active_param_count() * tokens)

    def serve_step(params, state, batch, pos):
        return T.decode_step(params, state, batch, pos, cfg)

    state = (decode_state_shape(cfg, sc.global_batch, sc.seq_len)
             if dev.type == "meta"
             else T.init_decode_state(cfg, sc.global_batch, sc.seq_len,
                                      device=dev))
    return Step(serve_step, (params, state, batch, sc.seq_len - 1), cfg, sc,
                1, 2.0 * cfg.active_param_count() * sc.global_batch)


def _storages(tree) -> Dict[int, int]:
    """storage -> bytes of a tree's tensors (each storage once)."""
    out = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def count_step(step: Step):
    """(outputs, OpCost, arg, out and alias bytes): one call of the step
    under the counter, its arguments live from the start."""
    grad = torch.enable_grad() if step.shape.kind == "train" \
        else torch.no_grad()
    args = _storages(step.args)
    with grad, OpCounter() as c:
        c.track(step.args)
        out = step.fn(*step.args)
    outs = _storages(out)
    alias = sum(b for k, b in outs.items() if k in args)
    return (out, c.cost, sum(args.values()), sum(outs.values()), alias)


def run_one(arch: str, shape_name: str, *, verbose: bool = True,
            microbatches: Optional[int] = None,
            cfg_overrides: Optional[dict] = None) -> dict:
    """The step counted on meta on the (1, 1) mesh: the reference's
    report fields (``RooflineReport``) and the memory of one card."""
    t0 = time.time()
    step = build_step(arch, shape_name, device="meta",
                      microbatches=microbatches, cfg_overrides=cfg_overrides)
    _, cost, arg_b, out_b, alias_b = count_step(step)
    t_count = time.time() - t0
    peak = cost.peak_bytes
    report = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=M.mesh_name(ONE_CARD),
        chips=1, flops=cost.flops, hbm_bytes=cost.hbm_bytes,
        model_flops=step.model_flops, peak_flops=M.PEAK_FLOPS_BF16,
        hbm_bw=M.HBM_BW, peak_memory_bytes=float(peak))
    out = report.to_dict()
    out.update(
        count_s=round(t_count, 2), microbatches=step.microbatches,
        ops=cost.ops, transcendentals=cost.transcendentals,
        kernels={k: {"calls": int(v[0]), "flops": v[1], "bytes": v[2]}
                 for k, v in sorted(cost.kernels.items())},
        arg_bytes=arg_b, out_bytes=out_b, alias_bytes=alias_b,
        temp_bytes=max(0.0, peak - (arg_b + out_b - alias_b)),
        fits_hbm=bool(peak <= M.HBM_PER_CHIP),
        top_hbm=cost.top_hbm(5), top_flops=cost.top_flops(5),
    )
    if verbose:
        print(f"== {arch} × {shape_name} × {out['mesh']} (1 card, meta; "
              f"microbatches {step.microbatches}) ==")
        print(f"  peak bytes/device: {peak / 1e9:.2f} GB (args "
              f"{arg_b / 1e9:.2f}, outputs {out_b / 1e9:.2f}, aliased "
              f"{alias_b / 1e9:.2f}) "
              f"({'FITS' if out['fits_hbm'] else 'EXCEEDS'} "
              f"{M.HBM_PER_CHIP / 1e9:.0f} GB)")
        print(f"  flops/device={report.flops_per_device:.3e} "
              f"hbm_bytes={report.hbm_bytes_per_device:.3e} "
              f"ops={cost.ops}")
        print(f"  roofline (data-sheet rates, not card times): compute="
              f"{report.compute_s * 1e3:.2f}ms memory="
              f"{report.memory_s * 1e3:.2f}ms collective="
              f"{report.collective_s * 1e3:.2f}ms -> bottleneck="
              f"{report.bottleneck}")
        print(f"  useful_flops_ratio={report.useful_flops_ratio:.3f} "
              f"counted in {t_count:.1f}s")
    return out


def table_bytes(arch: str, shape_name: str, *, multi_pod: bool,
                verbose: bool = True) -> dict:
    """Bytes one device holds of the step's sharded arguments on a
    reference TPU mesh, by the sharding tables: params, optimizer state
    (train), the decode state or the prefill cache, the batch. Table
    arithmetic: no temporaries, no roofline."""
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    step = build_step(arch, shape_name, device="meta", mesh=mesh)
    cfg, sc = step.cfg, step.shape
    params = step.args[0]
    pspecs = SH.param_specs(params, cfg, mesh)
    got = {"params": SH.per_device_bytes(params, pspecs, mesh)}
    if sc.kind == "train":
        _, opt, batch = step.args
        got["optimizer"] = (SH.per_device_bytes(opt.m, pspecs, mesh)
                            + SH.per_device_bytes(opt.v, pspecs, mesh))
        got["batch"] = SH.per_device_bytes(
            batch, SH.batch_specs(batch, mesh,
                                  microbatched=step.microbatches > 1), mesh)
    elif sc.kind == "prefill":
        batch = step.args[1]
        with torch.no_grad():
            _, cache = step.fn(*step.args)
        got["cache"] = SH.per_device_bytes(
            cache, SH.prefill_cache_specs(cache, cfg, mesh), mesh)
        got["batch"] = SH.per_device_bytes(
            batch, SH.batch_specs(batch, mesh), mesh)
    else:
        _, state, batch, _ = step.args
        got["cache"] = SH.per_device_bytes(
            state, SH.decode_state_specs(state, cfg, mesh), mesh)
        got["batch"] = SH.per_device_bytes(
            batch, SH.batch_specs(batch, mesh), mesh)
    out = dict(arch=arch, shape=shape_name, mesh=M.mesh_name(mesh),
               chips=math.prod(mesh.values()),
               kind="table arithmetic (sharded arguments only, no "
                    "temporaries, no roofline)",
               microbatches=step.microbatches, **{f"{k}_bytes": v
                                                  for k, v in got.items()},
               total_bytes=sum(got.values()))
    if verbose:
        print(f"== {arch} × {shape_name} × {out['mesh']} ({out['chips']} "
              f"devices; table arithmetic) == "
              + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in got.items())
              + f"; total {out['total_bytes'] / 2**30:.2f} GiB a device")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 TPU mesh's table arithmetic "
                         "in place of the one card's count")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16 x 16 and 2 x 16 x 16 meshes' table "
                         "arithmetic in place of the one card's count")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    if args.both_meshes:
        meshes = [False, True]
    elif args.multi_pod:
        meshes = [True]
    else:
        meshes = [None]

    results, failures = [], []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    if mp is None:
                        results.append(run_one(arch, shape))
                    else:
                        results.append(table_bytes(arch, shape,
                                                   multi_pod=mp))
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    failures.append(dict(
                        arch=arch, shape=shape,
                        mesh={None: "1x1", False: "16x16",
                              True: "2x16x16"}[mp], error=str(e)[:500]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} ok, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("FAIL:", f_["arch"], f_["shape"], f_["mesh"],
                  f_["error"][:200])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
