#!/usr/bin/env python3
"""Where kernel 8 (``csrc/policy_pd.cu``, the fp32 policy step) spends its
time, block by block, on one CUDA card.

It builds the kernel's source alone with ``-DPP_TRACE``, which compiles in
%globaltimer stamps that each block's thread 0 writes at the ends of its
phases (the shipped build has none), runs the shipped policy at each batch,
and prints the median over blocks of each phase's us and of each layer's
share, the spread of the blocks' start times (waves), the traced and the
shipped kernel's device time (the instrumentation's cost), the card's name
and power limit, and last one JSON line. Phases: the inputs (mbarriers,
cluster barrier, x, biases and PD inputs), layer l's K loop (from the previous phase's end, the wait for the
peers' slices included) and its output (partial sums, bias, ReLU, pushes),
layer 4 with its partial sums' pushes, the wait for the peers' partial sums,
and the PD epilogue.

With ``--bf16`` it traces kernel 8b (``csrc/policy_pd_bf16.cu``, built
alone with ``-DPB_TRACE``) instead: thread 0 of each block stamps each row tile's phases
(x into shared memory, layer 1, the wait for every block's layer-1 slice,
layer 2, the wait for the layer-2 slices, layer 3, layer 4, the wait for the
partial sums, the PD epilogue), and it prints the median over blocks and
tiles of each phase's us, a tile's us, the tiles a cluster walks, and the
traced and shipped kernel's device time.

    python3 scripts/trace_policy_kernel_torch.py [--batch 256 1000 4096]
    python3 scripts/trace_policy_kernel_torch.py --bf16 [--batch 256 1000 4096]
"""
import argparse
import ctypes
import hashlib
import json
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
KP, KD = 20.0, 1.5
STAMPS = 11     # csrc/policy_pd.cu PP_STAMPS
PHASES = ["inputs", "L1 K", "L1 out", "L2 K", "L2 out", "L3 K", "L3 out", "L4", "wait",
          "epilogue"]


def build_traced():
    """csrc/policy_pd.cu alone, with its stamps compiled in."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    src = _build.CSRC / "policy_pd.cu"
    flags = [*_build.NVCC_FLAGS, "-DPP_TRACE"]
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"policy_pd_traced_{tag}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.policy_pd_launch.argtypes = _build.SIGNATURES["policy_pd_launch"]
    lib.policy_pd_launch.restype = ctypes.c_int
    lib.pp_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


PHASES_BF16 = ["x", "L1", "L1 wait", "L2", "L2 wait", "L3", "L4", "sums wait", "epilogue"]


def build_traced_bf16():
    """csrc/policy_pd_bf16.cu alone, with its stamps compiled in."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    src = _build.CSRC / "policy_pd_bf16.cu"
    flags = [*_build.NVCC_FLAGS, "-DPB_TRACE"]
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"policy_pd_bf16_traced_{tag}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("policy_pd_bf16_launch", "policy_pd_bf16_attributes"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.pb_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def trace_bf16(args, card, dev, folded) -> dict:
    """Kernel 8b's phases per row tile, at the rows rule's tile."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        bf16_layers, make_fused_policy_pd, policy_pd_bf16_plain)
    from iterative_learning_nmpc_tpu_torch.utils.profiling import graph_time_ms

    layers = bf16_layers(folded, dev)
    dims = [47] + [int(W.shape[1]) for W, _ in layers[:3]] + [int(layers[3][1].shape[0])]
    ref_layers = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev))
                  for W, b in folded]
    shipped = make_fused_policy_pd(folded, KP, KD, compute_dtype=torch.bfloat16, device=dev)
    out = {"card": card, "traces": []}
    lib = build_traced_bf16()
    shape = (ctypes.c_int * 2)()
    lib.pb_trace_shape(shape)
    tmax, nst = shape
    for B in args.batch:
        at = (ctypes.c_int * 8)()
        _build.check(lib.policy_pd_bf16_attributes(B, *dims, at), "attributes")
        R, ncl = at[5], at[6]
        gen = torch.Generator().manual_seed(B)
        x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))

        def traced():
            act, tau = (torch.empty(B, dims[-1], device=dev) for _ in range(2))
            _build.check(lib.policy_pd_bf16_launch(
                x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
                *[t.data_ptr() for l in layers for t in l], act.data_ptr(), tau.data_ptr(),
                B, *dims[:4], 16, dims[4], KP, KD, torch.cuda.current_stream().cuda_stream),
                "traced policy_pd_bf16")
            return act, tau

        err = float((traced()[1] - policy_pd_bf16_plain(ref_layers, KP, KD, x, qj, vj)[1])
                    .abs().max())
        ms_traced = graph_time_ms(traced)
        ms = graph_time_ms(lambda: shipped(x, qj, vj))
        traced()
        torch.cuda.synchronize()
        nblk = ncl * 8
        buf = (ctypes.c_ulonglong * (nblk * tmax * nst))()
        _build.check(lib.pb_read_stamps(buf, nblk * tmax * nst), "pb_read_stamps")
        t = np.array(buf, dtype=np.float64).reshape(nblk, tmax, nst) / 1e3   # us
        tiles = -(-B // R)
        mine = [(tiles - c + ncl - 1) // ncl for c in range(ncl)]
        valid = np.array([[it < min(mine[blk // 8], tmax) for it in range(tmax)]
                          for blk in range(nblk)])
        d = np.diff(t, axis=2)[valid]                      # (block-tiles, phases)
        t0 = t[:, 0, 0].min()
        ends = np.array([t[b, min(mine[b // 8], tmax) - 1, -1] for b in range(nblk)]) - t0
        rec = dict(B=B, rows=R, clusters=ncl, tiles_max=max(mine), max_abs_dtau=err,
                   ms_shipped=ms, ms_traced=ms_traced,
                   phase_us=dict(zip(PHASES_BF16, np.median(d, 0).tolist())),
                   tile_us=float(np.median(d.sum(1))),
                   first_tile_us=float(np.median(d[:1].sum(1))),
                   last_end_us=float(ends.max()))
        out["traces"].append(rec)
        print(f"B={B} R={R} ({ncl} clusters, up to {max(mine)} tiles each): shipped "
              f"{ms * 1e3:.2f} us, traced {ms_traced * 1e3:.2f} us, max|dtau| vs twin "
              f"{err:.2e}; a tile {rec['tile_us']:.2f} us (median), last block ends "
              f"{rec['last_end_us']:.2f} us after the first tile starts ({card})", flush=True)
        print("  phases (median us): " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec["phase_us"].items()), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[256, 1000, 4096])
    ap.add_argument("--bf16", action="store_true", help="trace kernel 8b instead of kernel 8")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script traces the kernel on a GPU")
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        fold_batchnorm, policy_pd, policy_pd_plain)
    from iterative_learning_nmpc_tpu_torch.utils.profiling import graph_time_ms

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    with open(ARTIFACT, "rb") as f:
        folded = fold_batchnorm(pickle.load(f)["variables"])
    if args.bf16:
        print(json.dumps(trace_bf16(args, card, dev, folded)))
        return
    layers = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev))
              for W, b in folded]
    dims = [47] + [int(W.shape[1]) for W, _ in layers]
    lib = build_traced()
    rows = lib.pp_trace_rows()
    out = {"card": card, "rows": rows, "batches": {}}
    for B in args.batch:
        nblk = -(-B // rows) * 8
        if nblk * STAMPS > 1 << 16:
            sys.exit(f"B={B}: {nblk} blocks, more than the {(1 << 16) // STAMPS} traced")
        gen = torch.Generator().manual_seed(B)
        x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))

        def traced():
            act, tau = (torch.empty(B, dims[-1], device=dev) for _ in range(2))
            _build.check(lib.policy_pd_launch(
                x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
                *[t.data_ptr() for l in layers for t in l], act.data_ptr(), tau.data_ptr(),
                B, *dims, KP, KD, torch.cuda.current_stream().cuda_stream),
                "traced policy_pd")
            return act, tau

        err = float((traced()[1] - policy_pd_plain(layers, KP, KD, x, qj, vj)[1]).abs().max())
        ms_traced = graph_time_ms(traced)
        ms = graph_time_ms(lambda: policy_pd(layers, KP, KD, x, qj, vj))
        traced()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (nblk * STAMPS))()
        _build.check(lib.pp_read_stamps(buf, nblk * STAMPS), "pp_read_stamps")
        t = np.array(buf, dtype=np.float64).reshape(nblk, STAMPS) / 1e3   # us
        d = np.diff(t, axis=1)
        med = dict(zip(PHASES, np.median(d, 0)))
        per_block = t[:, -1] - t[:, 0]
        share = {f"layer {i + 1}": float(np.median((d[:, 1 + 2 * i] + d[:, 2 + 2 * i])
                                                   / per_block)) for i in range(3)}
        share["layer 4 + PD"] = float(np.median((d[:, 7] + d[:, 8] + d[:, 9]) / per_block))
        share["inputs"] = float(np.median(d[:, 0] / per_block))
        starts = t[:, 0] - t[:, 0].min()
        out["batches"][B] = dict(max_abs_dtau=err, ms=ms, ms_traced=ms_traced,
                                 phase_us=med, layer_share=share,
                                 block_us=float(np.median(per_block)),
                                 start_spread_us=float(starts.max()))
        print(f"B={B} ({rows} rows a cluster, {nblk // 8} clusters): kernel {ms * 1e3:.2f} us, "
              f"traced {ms_traced * 1e3:.2f} us, max|dtau| vs twin {err:.2e}; a block "
              f"{np.median(per_block):.2f} us, starts spread over {starts.max():.2f} us "
              f"({card})", flush=True)
        print("  phases (median us): " + ", ".join(f"{k} {v:.2f}" for k, v in med.items()),
              flush=True)
        print("  share of a block's time: " + ", ".join(f"{k} {v:.3f}"
                                                      for k, v in share.items()), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
