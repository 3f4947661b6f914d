#!/usr/bin/env python3
"""The policy-inference + PD step at datagen batch sizes, on one CUDA card:
the port of scripts/bench_policy_kernel.py.

  a) policy_pd: the fused fp32 kernel (csrc/policy_pd.cu), the reference's (a);
  b) policy_pd_bf16: the fused kernel with bf16 products on the tensor cores
     (csrc/policy_pd_bf16.cu), through make_fused_policy_pd(compute_dtype=
     torch.bfloat16);
  c) the batch-major fp32 addmm chain + PD on cuBLAS (policy_pd_plain), the
     reference's (c). The reference's (b), vmap(net.apply), has no
     counterpart: the port writes the batch dimension out, which is (c);
  d) the bf16 addmm chain on cuBLAS (layer 1 in fp32, layers 2-4 bf16 in and
     out with fp32 sums), the yardstick of (b);
  e) a seeded 47 -> 1024 x3 -> 12 net (``interop.random_policy_payload``)
     on policy_pd (kernel 8's wide layout: 16 rows a cluster, 128-column
     slices) and on the fp32 addmm chain.

With the shipped policy's folded weights (assets/
policy_go2_trot_ondevice_dagger.pkl) and seeded normal inputs, it times each
two ways: as the host calls it (``cuda_time_ms``: eager calls between CUDA
events, a wrapper's checks and launch included, the measure of every row
of PERF.md's kernel table) and by device time (``graph_time_ms``: the calls
replayed from a CUDA graph, the host's cost left out). It prints us per
call, max|dtau| of each against (c), both kernels' registers, local bytes,
shared memory and resident clusters (kernel 8b's also its rows a tile,
clusters launched and ring slots at each B), the card's name and power
limit, and last one JSON line.

``--root PARENT_TREE`` also builds both policy kernels of another checkout
(a parent commit unpacked with ``git archive``, say: its
``csrc/policy_pd.cu`` and ``csrc/policy_pd_bf16.cu``, each alone, with its
nvcc flags and C signatures from its ``ops/_build.py``; their launches must
take this checkout's arguments) and times each in the same process, in
turns with this checkout's kernel: parent, this, this, parent, and says
whether this checkout's fp32 kernel gives the parent's output bit for bit.

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


def standalone_launch(src: str, flags, argtypes, name: str):
    """``name`` from ``src`` built alone into a shared library (nvcc with
    ``flags``) in this checkout's build directory."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"alone_{os.path.basename(src)[:-3]}_{tag}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(out), src], check=True)
    fn = getattr(ctypes.CDLL(str(out)), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def parent_launches(root: str) -> dict:
    """The other checkout's policy_pd_launch and policy_pd_bf16_launch, each
    built alone with its nvcc flags and C signature."""
    path = os.path.join(root, "iterative_learning_nmpc_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    csrc = os.path.join(root, "iterative_learning_nmpc_tpu_torch", "csrc")
    return {name: standalone_launch(os.path.join(csrc, src), pb.NVCC_FLAGS,
                                    pb.SIGNATURES[name], name)
            for name, src in (("policy_pd_launch", "policy_pd.cu"),
                              ("policy_pd_bf16_launch", "policy_pd_bf16.cu"))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[256, 1000, 4096])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", help="another checkout whose kernels are timed in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this bench runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from iterative_learning_nmpc_tpu_torch.interop import random_policy_payload
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        bf16_kernel_attributes, bf16_layers, fold_batchnorm, kernel_attributes,
        make_fused_policy_pd, policy_pd_plain)
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
    bl = bf16_layers(layers, dev)
    w4 = bl[3][0][:, :bl[3][1].shape[0]].contiguous()
    dims = [47] + [int(W.shape[1]) for W, _ in dense]
    chain = lambda x, qj, vj: policy_pd_plain(dense, KP, KD, x, qj, vj)

    def chain16(x, qj, vj):
        h = torch.relu(torch.addmm(bl[0][1], x, bl[0][0])).to(torch.bfloat16)
        for (W, b), relu in ((bl[1], True), (bl[2], True), ((w4, bl[3][1]), False)):
            h = torch.addmm(b.to(torch.bfloat16), h, W)
            h = torch.relu(h) if relu else h
        a = h.float()
        return a, KP * (a - qj) - KD * vj

    def raw(launch, ls, n4):
        """A C launch entry of this signature as a policy step on ``ls``."""
        def fn(x, qj, vj):
            B = x.shape[0]
            act, tau = (torch.empty(B, dims[-1], device=dev) for _ in range(2))
            extra = [n4] if n4 else []
            _build.check(launch(x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
                                *[t.data_ptr() for l in ls for t in l], act.data_ptr(),
                                tau.data_ptr(), B, *dims[:-1], *extra, dims[-1], KP, KD,
                                torch.cuda.current_stream().cuda_stream), "launch")
            return act, tau
        return fn

    wide = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev))
            for W, b in fold_batchnorm(random_policy_payload(3, 1024, 1024)["variables"])]
    fp32_wide = make_fused_policy_pd(wide, KP, KD, device=dev)
    chain_wide = lambda x, qj, vj: policy_pd_plain(wide, KP, KD, x, qj, vj)
    fns = {"fp32_kernel": fp32, "bf16_kernel": bf16, "addmm_chain": chain,
           "bf16_chain": chain16, "fp32_kernel_3x1024": fp32_wide,
           "addmm_chain_3x1024": chain_wide}
    turns = ["fp32_kernel", "bf16_kernel"]
    if args.root:
        par = parent_launches(os.path.abspath(args.root))
        print(f"[parent] {os.path.abspath(args.root)}", flush=True)
        fns["parent_fp32_kernel"] = raw(par["policy_pd_launch"], dense, 0)
        fns["parent_bf16_kernel"] = raw(par["policy_pd_bf16_launch"], bl, 16)
        turns = [t for k in ("fp32_kernel", "bf16_kernel")
                 for t in (f"parent_{k}", k, k, f"parent_{k}")]
    attrs = kernel_attributes(dims, dev)
    print("[fp32 attributes] " + ", ".join(f"{k} {v}" for k, v in attrs.items()), flush=True)
    attrs_wide = kernel_attributes((47, 1024, 1024, 1024, 12), dev)
    print("[fp32 attributes, 3 x 1024] " + ", ".join(f"{k} {v}" for k, v in attrs_wide.items()),
          flush=True)
    attrs16 = {B: bf16_kernel_attributes(B, dims, dev) for B in args.batch}
    for B, at in attrs16.items():
        print(f"[bf16 attributes] B={B}: " + ", ".join(f"{k} {v}" for k, v in at.items()),
              flush=True)
    rows = []
    for B in args.batch:
        gen = torch.Generator().manual_seed(B)
        x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
        ref, ref_wide = chain(x, qj, vj)[1], chain_wide(x, qj, vj)[1]
        row = {"B": B}
        for name, fn in fns.items():
            r = ref_wide if name.endswith("3x1024") else ref
            row[f"{name}_max_dtau"] = float((fn(x, qj, vj)[1] - r).abs().max())
        if args.root:
            row["fp32_bit_equal_to_parent"] = all(
                torch.equal(a, b) for a, b in zip(fp32(x, qj, vj),
                                                  fns["parent_fp32_kernel"](x, qj, vj)))
        for name in turns + ["addmm_chain", "bf16_chain", "fp32_kernel_3x1024",
                             "addmm_chain_3x1024"]:
            call = lambda: fns[name](x, qj, vj)
            row.setdefault(f"{name}_us", []).append(cuda_time_ms(call, args.reps) * 1e3)
            row.setdefault(f"{name}_device_us", []).append(graph_time_ms(call, args.reps) * 1e3)
        rows.append(row)
        print(f"B={B:5d}: " + " | ".join(
            f"{k[:-3]} " + ", ".join(f"{v:.2f}" for v in row[k]) + " us"
            for k in row if k.endswith("_us")) + " | max|dtau| vs the chain: " + ", ".join(
            f"{k[:-9]} {row[k]:.2e}" for k in row if k.endswith("_max_dtau"))
              + (f" | fp32 kernel bit-equal to the parent's {row['fp32_bit_equal_to_parent']}"
                 if args.root else "") + f" ({card})", flush=True)
    print(json.dumps({"card": card, "reps": args.reps, "root": args.root, "attributes": attrs,
                      "attributes_3x1024": attrs_wide, "bf16_attributes": attrs16,
                      "rows": rows}))


if __name__ == "__main__":
    main()
