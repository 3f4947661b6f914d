#!/usr/bin/env python3
"""The policy-inference + PD step three ways at datagen batch sizes, on one
CUDA card: the port of scripts/bench_policy_kernel.py.

  a) policy_pd: the fused fp32 kernel (csrc/policy_pd.cu), the reference's (a);
  b) policy_pd_bf16: the fused kernel with bf16 products on the tensor cores
     (csrc/policy_pd_bf16.cu), through make_fused_policy_pd(compute_dtype=
     torch.bfloat16);
  c) the batch-major fp32 addmm chain + PD on cuBLAS (policy_pd_plain), the
     reference's (c). The reference's (b), vmap(net.apply), has no
     counterpart: the port writes the batch dimension out, which is (c).

With the shipped policy's folded weights (assets/
policy_go2_trot_ondevice_dagger.pkl) and seeded normal inputs, it times each
two ways: as the host calls it (``cuda_time_ms``: eager calls between CUDA
events, a wrapper's checks and launch included, the measure of every row
of PERF.md's kernel table) and by device time (``graph_time_ms``: the calls
replayed from a CUDA graph, the host's cost left out). It prints us per
call, max|dtau| of (a) and (b) against (c), kernel 8's registers, local
bytes, shared memory and resident clusters (cudaFuncGetAttributes), the
card's name and power limit, and last one JSON line.

``--root PARENT_TREE`` also builds the fp32 kernel of another checkout (a
parent commit unpacked with ``git archive``, say: only its
``csrc/policy_pd.cu``, with its nvcc flags and C signature from its
``ops/_build.py``; its ``policy_pd_launch`` must take this one's arguments)
and times it in the same process, in turns with this checkout's kernel:
change, parent, change, parent.

    python3 scripts/bench_policy_kernel_torch.py [--batch 256 1000 4096] [--reps 20]
        [--root PARENT_TREE]
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
KP, KD = 20.0, 1.5


def parent_launch(root: str):
    """The other checkout's policy_pd_launch, built alone with its nvcc
    flags into this checkout's build directory."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    path = os.path.join(root, "iterative_learning_nmpc_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    src = os.path.join(root, "iterative_learning_nmpc_tpu_torch", "csrc", "policy_pd.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(pb.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"parent_policy_pd_{tag}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *pb.NVCC_FLAGS, "-shared", "-o", str(out), src],
                       check=True)
    fn = ctypes.CDLL(str(out)).policy_pd_launch
    fn.argtypes = pb.SIGNATURES["policy_pd_launch"]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[256, 1000, 4096])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", help="another checkout whose fp32 kernel is timed in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this bench runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        fold_batchnorm, kernel_attributes, make_fused_policy_pd, policy_pd_plain)
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    with open(ARTIFACT, "rb") as f:
        layers = fold_batchnorm(pickle.load(f)["variables"])
    fp32 = make_fused_policy_pd(layers, KP, KD, device=dev)
    bf16 = make_fused_policy_pd(layers, KP, KD, compute_dtype=torch.bfloat16, device=dev)
    dense = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev)) for W, b in layers]
    dims = [47] + [int(W.shape[1]) for W, _ in dense]
    chain = lambda x, qj, vj: policy_pd_plain(dense, KP, KD, x, qj, vj)
    fns = {"fp32_kernel": fp32, "bf16_kernel": bf16, "addmm_chain": chain}
    if args.root:
        launch = parent_launch(os.path.abspath(args.root))
        print(f"[parent] {os.path.abspath(args.root)}", flush=True)

        def parent(x, qj, vj):
            B = x.shape[0]
            act, tau = (torch.empty(B, dims[-1], device=dev) for _ in range(2))
            _build.check(launch(x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
                                *[t.data_ptr() for l in dense for t in l], act.data_ptr(),
                                tau.data_ptr(), B, *dims, KP, KD,
                                torch.cuda.current_stream().cuda_stream), "parent policy_pd")
            return act, tau

        fns["parent_fp32_kernel"] = parent
    attrs = kernel_attributes(dims, dev)
    print("[attributes] " + ", ".join(f"{k} {v}" for k, v in attrs.items()), flush=True)
    turns = ["fp32_kernel", "parent_fp32_kernel"] * 2 if args.root else ["fp32_kernel"]
    rows = []
    for B in args.batch:
        gen = torch.Generator().manual_seed(B)
        x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
        ref = chain(x, qj, vj)[1]
        row = {"B": B}
        for name, fn in fns.items():
            row[f"{name}_max_dtau"] = float((fn(x, qj, vj)[1] - ref).abs().max())
        for name in turns + ["bf16_kernel", "addmm_chain"]:
            call = lambda: fns[name](x, qj, vj)
            row.setdefault(f"{name}_us", []).append(cuda_time_ms(call, args.reps) * 1e3)
            row.setdefault(f"{name}_device_us", []).append(graph_time_ms(call, args.reps) * 1e3)
        rows.append(row)
        print(f"B={B:5d}: " + " | ".join(
            f"{k[:-3]} " + ", ".join(f"{v:.2f}" for v in row[k]) + " us"
            for k in row if k.endswith("_us")) + " | max|dtau| vs the chain: " + ", ".join(
            f"{k[:-9]} {row[k]:.2e}" for k in row if k.endswith("_max_dtau")) + f" ({card})",
              flush=True)
    print(json.dumps({"card": card, "reps": args.reps, "root": args.root,
                      "attributes": attrs, "rows": rows}))

if __name__ == "__main__":
    main()
