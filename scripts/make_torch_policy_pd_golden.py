#!/usr/bin/env python3
"""Record kernel 8's output on the shipped policy, for the bit-for-bit
check of a later kernel 8 (tests/test_torch_cuda_kernels.py,
``test_policy_pd_kernel_bit_equal_to_golden``).

Builds ``csrc/policy_pd.cu`` of the checkout at ``--root`` alone (its nvcc
flags and C signature, as ``bench_policy_kernel_torch.py --root`` does),
serves the shipped policy's folded weights (assets/
policy_go2_trot_ondevice_dagger.pkl) to seeded normal inputs at B = 33 (a
partial cluster) and 256 (the datagen batch) on one CUDA card, and writes
the inputs and that kernel's act and tau to
tests/data/go2_trot_policy_pd_kernel_golden.npz, with the card's name and
power limit.

    python3 scripts/make_torch_policy_pd_golden.py --root TREE
"""
import argparse
import os
import pickle
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))
OUT = os.path.join(ROOT, "tests", "data", "go2_trot_policy_pd_kernel_golden.npz")
BATCHES, KP, KD = (33, 256), 20.0, 1.5


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="the checkout whose kernel 8 is recorded")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the golden is kernel 8's output on a GPU")
    from bench_policy_kernel_torch import ARTIFACT, parent_launches
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import fold_batchnorm

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    launch = parent_launches(os.path.abspath(args.root))["policy_pd_launch"]
    with open(ARTIFACT, "rb") as f:
        layers = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev))
                  for W, b in fold_batchnorm(pickle.load(f)["variables"])]
    dims = [47] + [int(W.shape[1]) for W, _ in layers]
    out = {"card": np.array(card)}
    for B in BATCHES:
        gen = torch.Generator().manual_seed(B)
        x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
        act, tau = (torch.empty(B, 12, device=dev) for _ in range(2))
        _build.check(launch(x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
                            *[t.data_ptr() for l in layers for t in l], act.data_ptr(),
                            tau.data_ptr(), B, *dims, KP, KD,
                            torch.cuda.current_stream().cuda_stream), "policy_pd_launch")
        torch.cuda.synchronize()
        for k, v in (("x", x), ("qj", qj), ("vj", vj), ("act", act), ("tau", tau)):
            out[f"{k}_{B}"] = v.cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"{args.out}: kernel 8 of {os.path.abspath(args.root)} at B = {BATCHES} ({card})")


if __name__ == "__main__":
    main()
