#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their public entry points and checks
every CUDA kernel of them against its plain PyTorch twin: the batched
warm-started RTI solve of the Go2 trot NMPC (N=25 nodes, 36-dim state,
30-dim input), the closed-loop controller (``LocomotionMPC``, one problem
per replan) driving the device plant, and the learned-policy serving path
(the shipped 47 -> 512x3 -> 12 policy served to 256 environments on the
device plant), and the training side (behaviour cloning on the datagen's
rows, and the on-device SafeDAgger loop). Phases, one line each:

  1. the card's name and power limit (nvidia-smi),
  2. build the kernels from ``iterative_learning_nmpc_tpu_torch/csrc``,
  3. the 15-iteration converged solve of the flagship problem (B=1): cost
     in the BENCH_ANCHOR.json band, controls and one RTI step within
     rel |dU| <= 1e-3 of the JAX-on-CPU golden (tests/data),
  4. the main path: a B=512 warm RTI chain with dual carry-over, with the
     kernels' launch counters set to 0 before it and read after it,
  5. each kernel against its plain twin at the chain's shapes (lingram at
     its first step, the others at its end state), timed with CUDA events;
     lingram per block and per part of each block, with every row group on
     and with each row group alone (ops/lingram.gram_gate), and its line also carries its
     three kernels' registers and local bytes (cudaFuncGetAttributes);
     riccati_rollout also at B=1 (one problem of the chain's end state, the
     closed loop's replan shape), and its line carries the Riccati kernels'
     registers, local bytes and resident blocks an SM; dyncore also at the
     shapes of its other paths (M = 52, the B=1 replan; 13,312, the B=256
     datagen; 51,712, the N=100 chain), timed eager and by CUDA-graph
     replay, and its line carries its registers, local bytes (0, or the
     run fails) and resident blocks an SM,
  6. one RTI step of the kernel path against the plain path on the card,
  7. dynjac against its plain twin at the controller's shape (M=25) and at
     M=512*25, every structural zero of J exact (ops/dynjac.structural_zeros),
     timed eager and by device time (CUDA-graph replay) at both, with its
     registers, local bytes (0, or the run fails) and resident blocks an
     SM; and one B=1 RTI step through the dynjac route and through the
     lingram route, timed with CUDA events,
  8. the closed loop: LocomotionMPC (Go2 trot, sync mode, phase-aligned
     boot) driving the device plant for 2.0 s at 1 kHz toward 0.3 m/s, with
     the launch counters set to 0 before it and read after it: base
     height, attitude, forward speed and replan latency,
  9. the controller's cold boot and first plan against the JAX-on-CPU
     golden (tests/data/go2_trot_closed_loop_golden.npz),
 11. the batched policy rollout of assets/policy_go2_trot_ondevice_dagger.pkl:
     256 envs from the standing pose (joint noise, env 0 clean), 0.3 m/s,
     1000 steps, counters set to 0 before it: at most 8 falls (the JAX
     reference's own spread), forward progress,
     policy_pd launched once per step and policy_pd_dense never, env 0
     against the JAX golden (tests/data/go2_trot_policy_rollout_golden.npz);
     then 200 steps of a seeded 5-layer policy (4 hidden layers of 256, the
     JAX network's class default; its output bias the standing joint
     angles), which kernel 8 does not take: finite states, policy_pd_dense
     once per step and policy_pd never,
 12. on-device expert datagen: 256 envs x 20 replanning intervals (0.8 s),
     counters set to 0 before it: the dataset gates of
     tests/test_ondevice.py, the batch solver's kernels launched,
 10. policy_pd against its plain twin (the fp32 addmm chain on cuBLAS) at
     B=256 (the datagen's last observations), 1000 (a ragged cluster) and
     4096, both timed once each way: eager calls between CUDA events (as
     every kernel) and device time (CUDA-graph replay); the kernel's
     registers, local bytes, shared memory and resident clusters
     (cudaFuncGetAttributes) (it runs after 12, whose rows it takes); and
     ServedPolicy's route (learning/network.py) for the shipped policy
     ("kernel"), a seeded 4 x 256 one ("dense", the fp32 addmm chain, as the
     JAX package serves any net) and a 3 x 1024 one ("kernel", kernel 8's
     wide layout), each on those observations against the addmm chain in
     float64; then the 3 x 1024 net on kernel 8 at the three batches, held
     to the float64 chain within kernel 8's bound and timed both ways
     beside the fp32 addmm chain, with its attributes,
 13. SafeDAgger mode: 256 envs x 8 intervals (policy for 20 steps, the MPC
     latched >= 60 steps once engaged), then B=2 x 2 intervals against the
     JAX golden (tests/data/go2_trot_safedagger_golden.npz),
 14. the long-horizon route (N=100 > 88 nodes: lingram, the sweep kernel
     with the terminal Gram, the rollout kernel, dyncore): a B=256 warm RTI
     chain of 5 steps from the JAX golden's converged point
     (tests/data/go2_trot_n100_golden.npz), perturbed as in phase 4, with
     the counters set to 0 before it and read after it (the fused kernel
     must not run); lingram against its twin at the chain's first step
     (as in phase 5), timed; both sweep kernels against
     their twins at its end state; the rollout kernel against its twin
     there and at B=512 (the 256 problems twice), timed against its bound,
     with its registers, local bytes (0, or the run fails) and resident
     blocks an SM; the
     fused kernel against the split chain on the same blocks, bit for bit,
     and both timed at N = 25, 88, 100; one B=2 RTI step against the golden's,
 15. the riccati_mode="pallas" + linearize_mode="jacfwd" route (the jacfwd
     Gram as torch ops, the sweep kernel from P_N, the rollout kernel,
     dyncore): a B=256, N=25 chain of 3 steps from phase 4's perturbation,
     counters as above (lingram and the fused kernel must not run); the
     sweep kernel against its twin, and the rollout kernel on its gains,
     timed; one RTI step against the N=25 golden,
 16. riccati_mode="sequential" and "associative" raise NotImplementedError,
 17. the bf16 policy (make_fused_policy_pd with compute_dtype=bfloat16, on
     the tensor cores) on phase 10's observations at B = 256, 1000 and 4096,
     and seeded nets of hidden widths (132, 100, 260) and 3 x 1024 at
     B=256, counters set to 0 before the five calls: against its plain twin
     (one bf16 ulp of the output scale) and fp32 serving (2^-5 of it), with
     its attributes (registers, local bytes, shared memory, resident and
     launched clusters, rows a tile, ring slots) at each shape, the shipped
     net timed both ways beside the bf16 addmm chain on cuBLAS, with phase
     10's times of the fp32 kernel and chain,
 18. the card's ceilings: fma_chain against its twin, then its fp32 FMA rate
     at full size (counters as above), and the HBM rate of x + 1.0 over 1 GiB,
 19. one Riccati node's factorize-and-solve under three thread mappings (a
     block running the production node stage of csrc/riccati.cuh, a warp,
     a thread per node) on the reference probe's blocks at B=1024, N=25,
     counters as above: each within 1e-5 of the twin and of the block
     mapping, timed there and at B=256,
 20. behaviour cloning at full width (learning/train.py): the valid rows of
     phase 12's datagen (goal = each env's v_des) into a Database,
     BehavioralCloning with the TrainConfig defaults (47 -> 512x3 -> 12,
     BatchNorm, batch 1024, lr 2e-3) for 3 epochs: ms a training step
     (CUDA events), rows/s, each epoch's losses and wall; the losses finite
     and falling; one epoch from the trained payload on 8,192 of the rows on
     the card and on the CPU, their per-step losses and parameters within
     the stated tolerance, and the same gate failing when one batch index
     of the CPU run is changed; the payload reloaded, served on route
     "kernel" and kernel 8 on phase 10's observations within its bound of
     the net's eval-mode forward,
 21. the on-device SafeDAgger loop (learning/dagger.py) at full width: a
     seeded untrained 3 x 512 BatchNorm policy, 256 envs, 0.4 s (10
     intervals), delay 20, MPC latched >= 60, one goal (0.3, 0, 0), 2
     iterations of (collect -> train: 3 epochs, batch 256, lr 1e-3), the
     counters set to 0 before each collect and read after it (kernels 1-3
     launched, kernel 8 once a control step, the dense route never): the
     JAX package's slow-test gates (two data steps, expert ratio > 0.3 at
     the first, the aggregate growing, the final payload new, loading and
     served on route "kernel"); each collect's and training's wall.

It then prints one JSON line with the kernels' results (each with its
bound: the larger of its operations over the card's fp32 rate, bf16
tensor-core work over the dense bf16 rate, and its bytes over the memory
rate, counted on this run's inputs; ``bound_measured_ms``, the same counts
over the ceilings of phase 18; for kernels 1, 2, 3 and 6 ``bound_algo_ms``,
the hand count of the minimal work over the same bytes) and, last, the
result line. Any failed check exits non-zero without that line; there is
no CPU fallback.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, CHAIN_STEPS, SEED = 512, 20, 0
REL_GATE = 1.0e-3          # the bench's rel |dU| / (1 + |U|) gate
LOOP_S, V_DES, BUDGET_MS = 2.0, 0.3, 40.0
# the learned-policy phases: the shipped policy, B environments from the
# standing pose with joint noise N(0, NOISE^2) (env 0 clean)
ARTIFACT = "policy_go2_trot_ondevice_dagger.pkl"
B_ENV, NOISE, V_MAX = 256, 0.03, 0.3
T_POLICY, PROGRESS_GATE = 1000, 0.15      # steps; mean forward metres after 1 s
# seeded policy shapes beside the shipped one (hidden layers, width, the
# route ServedPolicy takes: kernel 8 takes 4 layers of hidden widths <=
# 1024, 3 x 1024 in its wide layout), and the steps of the 4 x 256
# policy's rollout
OTHER_NETS, T_OTHER = ((4, 256, "dense"), (3, 1024, "kernel")), 200
# per-env trajectories decorrelate within ~0.3 s (stiff contact, policy
# feedback), so which envs fall is not reproducible across fp32 libraries:
# the JAX package on the CPU drops 0, 1, 2, 4, 4 of 256 over noise seeds 0-4
MAX_FALLS = 8
N_DATAGEN, N_DAGGER = 20, 8               # replanning intervals of 40 ms
DELAY_STEPS, MPC_MIN_STEPS = 20, 60
POLICY_KP, POLICY_KD = 20.0, 1.5
# the long-horizon and jacfwd routes (phases 14-15)
B_LONG, LONG_STEPS, CUTOVER_NS = 256, 5, (25, 88, 100)
B_JACFWD, JACFWD_STEPS = 256, 3
# dyncore's M at the B=1 replan, the B=256 datagen, the B=512 chain, N=100
DYNCORE_MS = (52, 2 * 256 * 26, 2 * 512 * 26, 2 * 256 * 101)
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores (every
# kernel here but policy_pd_bf16 is fp32 scalar code), dense bf16 on the
# tensor cores (policy_pd_bf16's layers 2-4), and HBM3
PEAK_FLOPS, PEAK_TC_FLOPS, PEAK_BYTES = 67.0e12, 989.0e12, 3.35e12
# the probes (phases 17-19): the bf16 policy at the fp32 policy's batches,
# the node solve at the reference probe's batch and at the sweep's
BF16_ULP = 2.0 ** -8
# phase 17's seeded nets beside the shipped one: uneven hidden widths (the
# factory pads them to 144, 112, 272) and the bf16 kernel's widest, 3 x 1024
BF16_WIDTHS = ((132, 100, 260), (1024, 1024, 1024))
NODE_B, NODE_N, NODE_B_SWEEP, NODE_REL = 1024, 25, 256, 1e-5
# the training side (phases 20-21): BC epochs on the datagen's rows, the
# rows of the card-against-CPU epoch, and the SafeDAgger loop's run
BC_EPOCHS, BC_CMP_ROWS, BC_CMP_SEEDS = 3, 8192, 4
DAGGER_SIM_S, DAGGER_ITERS, DAGGER_EPOCHS, DAGGER_BATCH, DAGGER_LR = 0.4, 2, 3, 256, 1e-3
# card against CPU after one epoch (7 steps), with the split and batches of
# each of BC_CMP_SEEDS seeds: per-step losses (fp32 sums in another order)
# and parameters (an L1 kink, an output within rounding of its target,
# flips one gradient sign and Adam carries it), except the noisy ones
# (``learning.train.trained_gaps``: the Dense biases feeding a BatchNorm,
# whose batch mean removes their gradient, the running means that follow
# them, and first-layer rows of constant input columns), held to ~10x the
# largest reading. Measured on an H100 80GB HBM3 at 700 W, seeds 0-3: losses
# 1.1e-7 to 4.2e-7, parameters 3.1e-5 to 1.1e-4, noisy 2.8e-4 to 4.4e-4;
# seed 0 with one batch index changed: 3.0e-2, 4.3e-1 and 5.4e-2; with the
# running means at momentum 0.99 (Flax's is 0.9): noisy 1.6e-1, the rest
# as without the fault
BC_LOSS_RTOL, BC_PARAM_ATOL, BC_NOISY_ATOL = 1e-4, 1e-3, 4.5e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def rel(a, b) -> float:
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def tensors_of(obj, out=None):
    """Every tensor in a nest of tuples, lists, dicts and dataclasses."""
    import dataclasses

    import torch

    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            tensors_of(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            tensors_of(o, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            tensors_of(getattr(obj, f.name), out)
    return out


def op_counter():
    """A dispatch mode counting the floating-point operations of every aten
    op it sees: 2 n k m for a product, n^3 / 3 for a Cholesky factor, n^2 k
    for a triangular solve, the largest operand's size for an elementwise op
    or a reduction, and nothing for layout and copies."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    import torch

    free = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
            "t", "select", "slice", "unsqueeze", "squeeze", "cat", "stack",
            "clone", "copy", "_to_copy", "to", "contiguous", "detach", "alias",
            "index", "index_select", "gather", "empty", "empty_strided", "zeros",
            "ones", "full", "new_zeros", "new_empty", "new_full", "new_ones",
            "zeros_like", "empty_like", "ones_like", "full_like", "lift_fresh",
            "arange", "linspace", "eye", "diag_embed", "diagonal", "as_strided",
            "split", "split_with_sizes", "unbind", "repeat", "repeat_interleave",
            "index_put", "fill", "scalar_tensor", "_local_scalar_dense",
            "expand_as", "flip", "narrow", "unfold", "diag", "tril", "triu",
            "select_scatter", "slice_scatter", "masked_fill", "where",
            "_unsafe_index", "nonzero", "is_nonzero", "item", "set_", "zero"}

    class OpCount(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ("mm", "bmm"):
                self.flops += 2 * args[0].numel() * args[1].shape[-1]
            elif name in ("addmm", "baddbmm"):
                self.flops += 2 * args[1].numel() * args[2].shape[-1]
            elif "cholesky_solve" in name or "triangular" in name:
                b, a = args[0], args[1]
                self.flops += (2 if "cholesky" in name else 1) * b.numel() * a.shape[-1]
            elif "cholesky" in name:
                n = args[0].shape[-1]
                self.flops += args[0].numel() // (n * n) * n ** 3 // 3
            elif name not in free:
                ts = [t for t in tree_leaves((args, kwargs, out))
                      if isinstance(t, torch.Tensor)]
                self.flops += max((t.numel() for t in ts), default=0)
            return out

    return OpCount()


def distinct_bytes(tensors) -> int:
    """Each distinct tensor's bytes, once."""
    seen, nbytes = set(), 0
    for t in tensors:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * t.element_size()
    return nbytes


def bound_of(flops, tc_flops, nbytes, peak_flops=PEAK_FLOPS, peak_bytes=PEAK_BYTES):
    """(bound_ms, bound_by): the larger of the operations' time (fp32 flops
    at peak_flops plus bf16 tensor-core flops at PEAK_TC_FLOPS) and the
    bytes' time at peak_bytes."""
    t_ops = (flops / peak_flops + tc_flops / PEAK_TC_FLOPS) * 1e3
    t_bytes = nbytes / peak_bytes * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound(plain_fn, args, out):
    """(bound_ms, bound_by, flops, bytes) of the function at these inputs:
    its operations counted on one call of the plain twin, its bytes each
    distinct input tensor read once and each output written once."""
    with op_counter() as oc:
        plain_fn(*args)
    nbytes = distinct_bytes(tensors_of(args) + tensors_of(out))
    return (*bound_of(oc.flops, 0.0, nbytes), oc.flops, nbytes)


def standing_state(spec):
    """The flagship's standing pose: (q (18,) float64, v = 0)."""
    import numpy as np

    from iterative_learning_nmpc_tpu_torch.models.dynamics import settled_state

    return settled_state(spec)[:18].astype(np.float64), np.zeros(18)


def noisy_starts(q0, n, rng):
    """n standing starts (n, 18): q0 with joint noise N(0, NOISE^2) on all
    but env 0."""
    import numpy as np

    qb = np.tile(np.reshape(q0, (1, -1)), (n, 1))
    qb[1:, 6:] += rng.normal(0, NOISE, (n - 1, 12)).astype(np.float32)
    return qb


def datagen_batch(q0, n, rng):
    """Phase 12's expert-datagen batch: n noisy standing starts at rest (n,
    36) and commands (n, 3), the forward speed uniform in [0, V_MAX)."""
    import numpy as np

    x0b = np.concatenate([noisy_starts(q0, n, rng), np.zeros((n, 18), np.float32)], 1)
    vd = np.zeros((n, 3), np.float32)
    vd[:, 0] = rng.uniform(0.0, V_MAX, n)
    return x0b, vd


class PlantData:
    """What LocomotionMPC.compute_torques_dof reads: time, qpos, qvel in
    MuJoCo layout."""
    time, qpos, qvel = 0.0, None, None


def policy_phases(dev, card, spec_d, q0, kernels, launches, record) -> dict:
    """Phases 10-13 on ``dev``: the shipped policy served to B_ENV
    environments by the policy rollout, the expert datagen and its SafeDAgger
    mode; ``record`` adds policy_pd's line to the kernels' results (its
    launches are the policy rollout's). Returns phase 10's policy_pd
    arguments by batch (the datagen's observations), which phase 17 serves
    again, phase 10's times by batch (kernel and fp32 addmm chain, eager
    and device), and phase 12's rows and commands, which phase 20 trains
    on."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy, random_policy_payload
    from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, load_policy
    from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        kernel_attributes, policy_pd, policy_pd_dense, policy_pd_plain)
    from iterative_learning_nmpc_tpu_torch.sim import device_sim
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    net, norm = load_policy(os.path.join(ROOT, "assets", ARTIFACT), device=dev)
    served = ServedPolicy(net, norm, device=dev)
    gold_r = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_policy_rollout_golden.npz"))
    gold_d = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_safedagger_golden.npz"))
    dq0 = float(np.abs(q0 - gold_r["q0"][0]).max())
    if dq0 > 1e-6:
        fail(f"the standing pose differs from the learning golden's by {dq0:.2e}")
    rng = np.random.default_rng(SEED)

    def zero_counters():
        for k in kernels:
            k.launches = 0
        policy_pd_dense.calls = 0
        torch.cuda.synchronize()

    # ---- 11. batched policy rollout ----
    q0b = noisy_starts(gold_r["q0"][:1], B_ENV, rng)
    vd = np.tile(np.array([[V_DES, 0.0, 0.0]], np.float32), (B_ENV, 1))
    rollout = device_sim.make_batched_policy_rollout(spec_d, (net, norm), T_POLICY, device=dev)
    zero_counters()
    t0 = time.perf_counter()
    Q, V, fell = rollout(q0b, np.zeros((B_ENV, 18), np.float32), vd)
    torch.cuda.synchronize()
    wall_pol = time.perf_counter() - t0
    pol_launches, pol_dense = policy_pd.launches, policy_pd_dense.calls
    Q, V, fell = Q.cpu().numpy(), V.cpu().numpy(), fell.cpu().numpy()
    prog = Q[:, -1, 0] - q0b[:, 0]
    T_g = gold_r["Q"].shape[1]
    e_q = float(np.abs(Q[0, :T_g] - gold_r["Q"][0]).max())
    e_vb = float(np.abs(V[0, :T_g, :6] - gold_r["V"][0, :, :6]).max())
    e_v10 = float(np.abs(V[0, :10] - gold_r["V"][0, :10]).max())
    print(f"[policy rollout] B={B_ENV} T={T_POLICY} (artifact, 0.3 m/s, joint noise "
          f"{NOISE}): fell {int(fell.sum())}, progress mean {prog.mean():.4f} m "
          f"(min {prog.min():.4f}), base z {Q[..., 2].min():.4f}..{Q[..., 2].max():.4f}, "
          f"policy_pd launches {pol_launches}, wall {wall_pol:.2f} s "
          f"({wall_pol / T_POLICY * 1e3:.3f} ms per control step; {card}); env 0 vs "
          f"JAX golden over {T_g} steps: q {e_q:.2e} (<= 5e-3), base v {e_vb:.2e} "
          f"(<= 0.1), v over 10 steps {e_v10:.2e} (<= 2e-3)", flush=True)
    if not np.isfinite(Q).all() or int(fell.sum()) > MAX_FALLS:
        fail(f"policy rollout: {int(fell.sum())} envs fell (> {MAX_FALLS}) or "
             "non-finite states")
    if not prog.mean() > PROGRESS_GATE:
        fail(f"policy rollout: mean progress {prog.mean():.4f} m <= {PROGRESS_GATE}")
    if pol_launches != T_POLICY or pol_dense != 0:
        fail(f"policy rollout launched policy_pd {pol_launches} times, not {T_POLICY}, or "
             f"took the dense route ({pol_dense} calls)")
    # tests/test_torch_policy.py's bounds: foot impacts amplify the
    # plant's ~1e-5 per-step fp32 differences through the policy
    if not (e_q <= 5e-3 and e_vb <= 0.1 and e_v10 <= 2e-3):
        fail("policy rollout env 0 disagrees with the JAX golden")
    # a 5-layer policy, which kernel 8 does not take, served by the dense route
    n_hidden, width, _ = OTHER_NETS[0]
    other = policy_from_numpy(random_policy_payload(n_hidden, width, SEED, q_stand=q0[6:]),
                              device=dev)
    rollout5 = device_sim.make_batched_policy_rollout(spec_d, other, T_OTHER, device=dev)
    zero_counters()
    t0 = time.perf_counter()
    Q5, V5, fell5 = rollout5(q0b, np.zeros((B_ENV, 18), np.float32), vd)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    n5 = (policy_pd.launches, policy_pd_dense.calls)
    finite5 = bool(torch.isfinite(Q5).all() and torch.isfinite(V5).all())
    print(f"[policy rollout, {n_hidden} x {width}] B={B_ENV} T={T_OTHER} (seeded weights holding "
          f"the stance): finite {finite5}, fell {int(fell5.sum())} (informational), "
          f"policy_pd launches {n5[0]}, policy_pd_dense calls {n5[1]}, "
          f"{wall5 / T_OTHER * 1e3:.3f} ms per control step ({card})", flush=True)
    if not finite5 or n5 != (0, T_OTHER):
        fail(f"the {n_hidden} x {width} policy rollout went non-finite or did not take the "
             f"dense route once a step: {n5}")

    # ---- 12. on-device expert datagen ----
    x0b, vd = datagen_batch(gold_r["q0"][:1], B_ENV, rng)
    datagen = make_batched_mpc_rollout(spec_d, n_intervals=N_DATAGEN, device=dev)
    zero_counters()
    t0 = time.perf_counter()
    rows = datagen(x0b, vd)
    torch.cuda.synchronize()
    wall_dg = time.perf_counter() - t0
    dg_launches = {k.__name__: k.launches for k in kernels}
    T_dg = rows.q.shape[1]
    z = rows.q[..., 2]
    valid = float(rows.valid.mean())
    finite = all(bool(torch.isfinite(t).all()) for t in rows)
    act_max = float(rows.action.abs().max())
    print(f"[datagen] B={B_ENV} x {N_DATAGEN} intervals ({T_dg} control steps, vx ~ "
          f"U(0, {V_MAX})): valid {valid:.4f}, base z {float(z.min()):.4f}.."
          f"{float(z.max()):.4f}, |action| max {act_max:.3f}, finite {finite}, "
          f"{B_ENV * T_dg / wall_dg:.1f} rows/s ({wall_dg:.2f} s wall, "
          f"{wall_dg / T_dg * 1e3:.3f} ms per control step; {card}; informational), "
          f"launches {dg_launches}", flush=True)
    if not (valid > 0.9 and float(z.min()) > 0.15 and float(z.max()) < 0.45
            and finite and act_max < 4.0):
        fail("datagen rows outside the gates of tests/test_ondevice.py")
    if min(dg_launches[k] for k in ("lingram", "riccati_rollout", "dyncore")) <= 0:
        fail(f"datagen did not launch the batch solver's kernels: {dg_launches}")

    datagen_rows = (rows, vd)

    # ---- 10. policy_pd against its twin, on the datagen's observations ----
    layers = served.layers
    dims = [int(layers[0][0].shape[0])] + [int(W.shape[1]) for W, _ in layers]
    flat = lambda t: t.reshape(-1, t.shape[-1])
    obs = served.normalize(flat(rows.state44),
                           torch.as_tensor(vd, device=dev).repeat_interleave(T_dg, 0))
    qj_all, vj_all = flat(rows.q)[:, 6:].contiguous(), flat(rows.v)[:, 6:].contiguous()
    pick = torch.randperm(obs.shape[0], generator=torch.Generator().manual_seed(SEED))
    pp_results = {}
    for nb in (B_ENV, 1000, 4096):
        idx = (torch.arange(B_ENV) * T_dg + T_dg - 1 if nb == B_ENV else pick[:nb]).to(dev)
        args = (layers, POLICY_KP, POLICY_KD, obs[idx].contiguous(), qj_all[idx], vj_all[idx])
        (ak, tk), (ap, tp) = policy_pd(*args), policy_pd_plain(*args)
        torch.cuda.synchronize()
        # tests/test_policy_kernel.py's bounds: fp32 sums over K = 512
        # reassociated, tau scaled by kp
        ok = bool(((ak - ap).abs() <= 2e-5 + 2e-4 * ap.abs()).all()
                  and ((tk - tp).abs() <= 1e-3 + 2e-4 * tp.abs()).all())
        err = max(float((ak - ap).abs().max()), float((tk - tp).abs().max()))
        # as every kernel's line: eager calls between CUDA events (the
        # kernel's twin is the fp32 addmm chain on cuBLAS); and the device
        # time of each (CUDA-graph replay, the host's cost left out)
        ms = cuda_time_ms(lambda: policy_pd(*args), 50)
        chain_ms = cuda_time_ms(lambda: policy_pd_plain(*args), 20)
        device_ms = graph_time_ms(lambda: policy_pd(*args))
        device_chain_ms = graph_time_ms(lambda: policy_pd_plain(*args))
        pp_results[nb] = (err, ok, ms, chain_ms, device_ms, device_chain_ms, args, (ak, tk))
        b_ms, b_by, flops, nbytes = bound(policy_pd_plain, args, (ak, tk))
        print(f"[policy_pd] B={nb}: max_abs_err {err:.3e}, {ms:.4f} ms vs the fp32 addmm "
              f"chain {chain_ms:.4f} ms; device time {device_ms:.4f} vs {device_chain_ms:.4f} "
              f"ms; bound {b_ms:.6f} ms by {b_by} ({flops:.4e} flop, {nbytes} B; {card})",
              flush=True)
    attrs = kernel_attributes(dims, dev)
    print("[policy_pd] " + ", ".join(f"{k} {v}" for k, v in attrs.items()), flush=True)
    # ServedPolicy's route for every policy shape, on the datagen's last
    # rows, against the addmm chain in float64
    last = torch.arange(B_ENV, device=dev) * T_dg + T_dg - 1
    s44, qj, vj = flat(rows.state44)[last], qj_all[last], vj_all[last]
    goal = torch.as_tensor(vd, device=dev)
    nets = [("shipped", served, "kernel")] + [
        (f"{nh} x {wd}", ServedPolicy(*policy_from_numpy(random_policy_payload(nh, wd, SEED),
                                                         device=dev), device=dev), route)
        for nh, wd, route in OTHER_NETS]
    for name, sp, want in nets:
        n0 = (policy_pd.launches, policy_pd_dense.calls)
        ak, tk = sp(s44, goal, qj, vj, POLICY_KP, POLICY_KD)
        torch.cuda.synchronize()
        n1 = (policy_pd.launches - n0[0], policy_pd_dense.calls - n0[1])
        ap, tp = policy_pd_plain([(W.double(), b.double()) for W, b in sp.layers], POLICY_KP,
                                 POLICY_KD, sp.normalize(s44, goal).double(), qj.double(),
                                 vj.double())
        ak, tk = ak.double(), tk.double()
        err = max(float((ak - ap).abs().max()), float((tk - tp).abs().max()))
        ok = bool(((ak - ap).abs() <= 2e-5 + 2e-4 * ap.abs()).all()
                  and ((tk - tp).abs() <= 1e-3 + 2e-4 * tp.abs()).all())
        dims_n = [int(sp.layers[0][0].shape[0])] + [int(W.shape[1]) for W, _ in sp.layers]
        print(f"[policy routes] {name} {dims_n}: route {sp.route} (kernel 8 launches {n1[0]}, "
              f"dense calls {n1[1]}), B={B_ENV} max_abs_err to the float64 chain {err:.3e} "
              f"({'within' if ok else 'OUTSIDE'} |d act| <= 2e-5 + 2e-4 |act|, |d tau| <= "
              f"1e-3 + 2e-4 |tau|; {card})", flush=True)
        if sp.route != want or n1 != ((1, 0) if want == "kernel" else (0, 1)) or not ok:
            fail(f"ServedPolicy {name}: route {sp.route} (want {want}), calls {n1}, within the "
                 f"bound {ok}")
    # the 3 x 1024 net on kernel 8 (its wide layout: 16 rows a cluster,
    # 128-column slices) at each batch, against the addmm chain in float64
    # within kernel 8's bound, timed beside the fp32 addmm chain
    wide = next(sp for name, sp, _ in nets if name == "3 x 1024")
    wide_results = {}
    for nb, (_, _, _, _, _, _, a_nb, _) in pp_results.items():
        a_w = (wide.layers, *a_nb[1:])
        ak, tk = policy_pd(*a_w)
        ap, tp = policy_pd_plain([(W.double(), b.double()) for W, b in wide.layers], POLICY_KP,
                                 POLICY_KD, *(t.double() for t in a_nb[3:]))
        torch.cuda.synchronize()
        ak, tk = ak.double(), tk.double()
        ok_w = bool(((ak - ap).abs() <= 2e-5 + 2e-4 * ap.abs()).all()
                    and ((tk - tp).abs() <= 1e-3 + 2e-4 * tp.abs()).all())
        wide_results[nb] = dict(
            max_abs_err=max(float((ak - ap).abs().max()), float((tk - tp).abs().max())), ok=ok_w,
            ms=cuda_time_ms(lambda: policy_pd(*a_w), 20),
            library_chain_ms=cuda_time_ms(lambda: policy_pd_plain(*a_w), 20),
            device_ms=graph_time_ms(lambda: policy_pd(*a_w)),
            device_chain_ms=graph_time_ms(lambda: policy_pd_plain(*a_w)))
    wide_attrs = kernel_attributes([47, 1024, 1024, 1024, 12], dev)
    print("[policy_pd 3 x 1024] " + "; ".join(
        f"B={nb}: err to the float64 chain {r['max_abs_err']:.3e} "
        f"({'within' if r['ok'] else 'OUTSIDE'} kernel 8's bound), kernel {r['ms']:.4f} ms "
        f"(device {r['device_ms']:.4f}) vs the fp32 addmm chain {r['library_chain_ms']:.4f} ms "
        f"(device {r['device_chain_ms']:.4f})" for nb, r in wide_results.items())
        + "; " + ", ".join(f"{k} {v}" for k, v in wide_attrs.items()) + f" ({card})", flush=True)
    err, ok, ms, chain_ms, _, _, args, out_k = pp_results[B_ENV]
    launches["policy_pd"] = pol_launches
    times = {key: {nb: r[i] for nb, r in pp_results.items()} for i, key in
             enumerate(("ms_by_batch", "library_chain_ms", "device_ms_by_batch",
                        "device_chain_ms"), start=2)}
    record("policy_pd", "iterative_learning_nmpc_tpu_torch/csrc/policy_pd.cu",
           "iterative_learning_nmpc_tpu/ops/policy_kernel.py:60",
           max(r[0] for r in pp_results.values()), all(r[1] for r in pp_results.values()),
           "|d act| <= 2e-5 + 2e-4 |act|, |d tau| <= 1e-3 + 2e-4 |tau| at B = "
           + ", ".join(map(str, pp_results)) + ", and for 3 x 1024 against the float64 chain",
           ms, chain_ms, policy_pd_plain, args, out_k,
           extra=dict(times, kernel_attributes=attrs,
                      wide_3x1024=dict(by_batch=wide_results, kernel_attributes=wide_attrs)))
    if not all(r["ok"] for r in wide_results.values()):
        fail("policy_pd at 3 x 1024 is outside kernel 8's bound of the float64 chain")

    # ---- 13. SafeDAgger mode ----
    x0b = np.concatenate([noisy_starts(gold_r["q0"][:1], B_ENV, rng),
                          np.zeros((B_ENV, 18), np.float32)], 1)
    vd = np.tile(np.array([[V_DES, 0.0, 0.0]], np.float32), (B_ENV, 1))
    dagger = make_batched_mpc_rollout(
        spec_d, n_intervals=N_DAGGER, policy=(net, norm), delay_steps=DELAY_STEPS,
        mpc_min_steps=MPC_MIN_STEPS, device=dev)
    zero_counters()
    t0 = time.perf_counter()
    rows = dagger(x0b, vd)
    torch.cuda.synchronize()
    wall_sd = time.perf_counter() - t0
    sd_launches = {k.__name__: k.launches for k in kernels}
    exp, valid = rows.is_expert.cpu().numpy(), float(rows.valid.mean())
    T_sd = exp.shape[1]
    print(f"[safedagger] B={B_ENV} x {N_DAGGER} intervals ({T_sd} steps, delay "
          f"{DELAY_STEPS}, MPC latched >= {MPC_MIN_STEPS}): expert share "
          f"{exp.mean():.4f}, policy-only over the delay {bool((exp[:, :DELAY_STEPS] == 0).all())}, "
          f"valid {valid:.4f}, wall {wall_sd:.2f} s ({wall_sd / T_sd * 1e3:.3f} ms per "
          f"control step; {card}), launches {sd_launches}", flush=True)
    if not ((exp[:, :DELAY_STEPS] == 0).all() and sd_launches["policy_pd"] > 0):
        fail("SafeDAgger: the expert acted during the delay or policy_pd never ran")
    if not valid > 0.9:
        fail(f"SafeDAgger: valid share {valid:.4f} <= 0.9")
    small = make_batched_mpc_rollout(
        spec_d, n_intervals=int(gold_d["n_intervals"]), policy=(net, norm),
        delay_steps=int(gold_d["delay_steps"]), mpc_min_steps=int(gold_d["mpc_min_steps"]),
        device=dev)
    rows = {k: v.cpu().numpy() for k, v in small(gold_d["x0"], gold_d["v_des"])._asdict().items()}
    same = all(np.array_equal(rows[k], gold_d[k]) for k in ("is_expert", "valid"))
    err = lambda k, n=None, cols=slice(None): float(
        np.abs(rows[k][:, :n][..., cols] - gold_d[k][:, :n][..., cols]).max())
    errs = dict(q1=err("q", 40), v1=err("v", 40, slice(0, 6)), a1=err("action", 40),
                q=err("q"), a=err("action"))
    print(f"[safedagger vs JAX] B=2 x {int(gold_d['n_intervals'])} intervals: is_expert "
          f"and valid identical {same}; first interval: q {errs['q1']:.2e} (<= 5e-3), "
          f"base v {errs['v1']:.2e} (<= 0.1), action {errs['a1']:.2e} (<= 5e-2); all "
          f"rows: q {errs['q']:.2e} (<= 5e-2), action {errs['a']:.2e} (<= 0.15)", flush=True)
    # tests/test_torch_ondevice.py's bounds: once the expert takes over the
    # closed loop doubles the rows' fp32 deviation every ~10 steps
    if not (same and errs["q1"] <= 5e-3 and errs["v1"] <= 0.1 and errs["a1"] <= 5e-2
            and errs["q"] <= 5e-2 and errs["a"] <= 0.15):
        fail("SafeDAgger B=2 disagrees with the JAX golden")
    return {nb: r[6] for nb, r in pp_results.items()}, times, datagen_rows


def b1_route_ms(solver, X, U, p, reps: int = 20) -> dict:
    """One B=1 RTI step (linearize + riccati + the merit of the line-search
    alphas) from (X, U, p), by the dynjac route (``lingram_structured`` on
    kernel 7) and by the lingram route: ms between CUDA events."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac
    from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram
    from iterative_learning_nmpc_tpu_torch.ops.riccati import riccati_rollout
    from iterative_learning_nmpc_tpu_torch.solver.linearize import cost_dual, lingram_structured
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    spec, w, N = solver.spec, solver.weights, solver.N
    inc = solver.opt.torque_limit_in_qp
    alphas = torch.tensor(solver.opt.ls_alphas_steady, device=X.device)
    nA = len(alphas)

    def step(route):
        dX, dU = riccati_rollout(
            spec, w, solver.dt_nodes, float(solver.opt.lm_reg), float(solver.cost.reg_eps_e),
            *route(), solver._defects(X, U, p), p.x0 - X[:, 0], X[:, -1], p.peak[:, :, -1],
            p.base_ref_e, p.joint_ref, p.step_height)
        a = alphas[:, None, None, None]
        Xc = (X[None] + a * dX[None]).reshape(-1, N + 1, 36)
        Uc = (U[None] + a * dU[None]).reshape(-1, N, 30)
        return cost_dual(spec, w, Xc, Uc, p.map(lambda t: t.repeat((nA,) + (1,) * (t.dim() - 1))))

    return {"dynjac_route_ms": cuda_time_ms(lambda: step(lambda: lingram_structured(
                spec, w, X, U, p, inc, dynjac_fn=dynjac)), reps),
            "lingram_route_ms": cuda_time_ms(lambda: step(lambda: lingram(
                spec, w, X, U, p, inc)), reps)}


def step_gate(gains_k, gains_p, gains64, h, defects, dx0):
    """(max |d gains|, ok, text) of a sweep kernel's gains against its
    twin's. fp32 gains are ill-conditioned near the end of a long horizon
    (one ulp of noise on the GN blocks moves K by a few 1e-3 of its scale,
    and the steps of two fp32 sweeps differ by up to 1e-2 over 256
    problems), so both are held to the float64 twin: the step the kernel's
    gains give (the rollout in float64) no further from the float64 step
    than twice the fp32 twin's, plus REL_GATE / 10."""
    from iterative_learning_nmpc_tpu_torch.ops.riccati import forward_rollout_plain

    def step(g):
        return forward_rollout_plain(h, g.double(), defects.double(), dx0.double())

    ref = step(gains64)
    r_k, r_p = (max(rel(a, b) for a, b in zip(step(g), ref)) for g in (gains_k, gains_p))
    err = float((gains_k - gains_p).abs().max())
    scaled = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in ((gains_k[..., :36], gains_p[..., :36]),
                              (gains_k[..., 36], gains_p[..., 36])))
    ok = r_k <= 2.0 * r_p + 0.1 * REL_GATE
    return err, ok, (f"step rel |d(dU, dX)| to the float64 sweep's {r_k:.2e} <= 2 x the "
                     f"fp32 twin's {r_p:.2e} + {0.1 * REL_GATE:.0e}; gains vs twin "
                     f"{scaled:.2e} of scale")


def rollout_case(a5, card):
    """Kernel 5 (forward_rollout) on a5 = (h, gains, defects, dx0) against
    its twin: rel |d(dU, dX)| / (1 + |plain|) within REL_GATE, or no
    further from the float64 rollout than twice the twin, plus REL_GATE /
    10; timed (CUDA events) beside the twin, with its bound. Returns (the
    numbers, the kernel's (dX, dU))."""
    from iterative_learning_nmpc_tpu_torch.ops.riccati import forward_rollout, forward_rollout_plain
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    out_k, out_p = forward_rollout(*a5), forward_rollout_plain(*a5)
    out64 = forward_rollout_plain(a5[0], *(x.double() for x in a5[1:]))
    r, r_k, r_p = (max(rel(a, b) for a, b in zip(x, y))
                   for x, y in ((out_k, out_p), (out_k, out64), (out_p, out64)))
    ms = cuda_time_ms(lambda: forward_rollout(*a5), 50)
    plain_ms = cuda_time_ms(lambda: forward_rollout_plain(*a5), 3)
    b_ms, b_by, flops, nbytes = bound(forward_rollout_plain, a5, out_k)
    B, N = a5[1].shape[:2]
    c = dict(max_abs_err=max(float((a - b).abs().max()) for a, b in zip(out_k, out_p)),
             rel=r, rel_f64=r_k, rel_f64_plain=r_p,
             ok=r <= REL_GATE or r_k <= 2.0 * r_p + 0.1 * REL_GATE, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by)
    print(f"[forward_rollout] B={B} N={N}: {ms:.4f} ms ({ms / b_ms:.2f}x its bound {b_ms:.6f} ms "
          f"by {b_by}: {flops:.4e} flop, {nbytes} B) vs plain {plain_ms:.4f} ms; rel to the "
          f"twin {r:.2e}, to the float64 rollout {r_k:.2e} (twin {r_p:.2e}) "
          f"{'ok' if c['ok'] else 'OUTSIDE'} ({card})", flush=True)
    return c, out_k


def riccati_route_phases(dev, card, solver, conv, params, golden, kernels, launches,
                         record) -> dict:
    """Phases 14-16 on ``dev``: the long-horizon split route (kernels 4 and
    5), the pallas + jacfwd route (kernels 6 and 5) and the refusals;
    ``record`` adds the three kernels' lines (launches from 14 for kernels 4
    and 5, from 15 for kernel 6). Returns lingram's numbers at N=100 for
    its line."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.ops.lingram import (
        gate_failures, gate_summary, gram_gate, lingram, lingram_plain)
    from iterative_learning_nmpc_tpu_torch.ops.probes import (
        algo_flops_lingram, algo_flops_riccati)
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        forward_rollout, forward_rollout_plain, riccati_rollout, riccati_sweep,
        riccati_sweep_plain, riccati_sweep_terminal, riccati_sweep_terminal_plain,
        terminal_gram)
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        kernel_attributes as riccati_attributes)
    from iterative_learning_nmpc_tpu_torch.solver.linearize import gn_blocks_jacfwd
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    def run_chain(s, X, U, p, lam_ineq, steps):
        """``steps`` warm RTI solves from (X, U) with the counters set to 0
        before and read after: (end state, costs, wall s, launches)."""
        lam_eq = torch.zeros_like(p.lam_eq)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = F.rti_chain(s, X, U, lam_eq, lam_ineq, p, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k.__name__: k.launches for k in kernels}

    def step_args(s, X, U, p):
        """The sweeps' arguments at (X, U, p): spec .. reg_e, defects, the
        terminal inputs, dx0."""
        return ((s.spec, s.weights, s.dt_nodes, float(s.opt.lm_reg),
                 float(s.cost.reg_eps_e)), s._defects(X, U, p),
                (X[:, -1], p.peak[:, :, -1], p.base_ref_e, p.joint_ref, p.step_height),
                p.x0 - X[:, 0])

    # ---- 14. the long-horizon route, N=100 ----
    g = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_n100_golden.npz"))
    sol_l, _, _, p_l = F.flagship(device=dev, n_nodes=100)
    if not (float(np.abs(p_l.x0[0].cpu().numpy() - g["x0"]).max()) <= 1e-6
            and np.array_equal(p_l.cnt[0].cpu().numpy(), g["cnt"])):
        fail("the N=100 flagship differs from the golden instance")
    t = lambda a: torch.as_tensor(a, device=dev)
    Xc, Uc = t(g["X_conv"])[None], t(g["U_conv"])[None]
    Xb, Ub, pb = F.perturbed_batch(Xc, Uc, p_l, B_LONG, seed=SEED)
    lam_ineq = t(g["lam_ineq_conv"])[None].expand_as(pb.lam_ineq).contiguous()
    # lingram at the chain's first step, as phase 5 holds it at N=25
    la = (sol_l.spec, sol_l.weights, Xb, Ub,
          pb.replace(lam_eq=torch.zeros_like(pb.lam_eq), lam_ineq=lam_ineq),
          sol_l.opt.torque_limit_in_qp)
    blocks_k = lingram(*la)
    gate = gram_gate(lingram, *la)
    ms_l, plain_l = cuda_time_ms(lambda: lingram(*la), 20), cuda_time_ms(
        lambda: lingram_plain(*la), 3)
    b_l, by_l, fl_l, nb_l = bound(lingram_plain, la, blocks_k)
    n100 = dict(max_abs_err_n100=max(r[1] for r in gate["all"]), ms_n100=ms_l,
                plain_ms_n100=plain_l, bound_ms_n100=b_l, bound_algo_ms_n100=bound_of(
                    algo_flops_lingram(B_LONG, sol_l.N), 0.0, nb_l)[0])
    print(f"[lingram N=100] B={B_LONG} N={sol_l.N}: {ms_l:.4f} ms vs plain {plain_l:.4f} ms, "
          f"bound {b_l:.6f} ms by {by_l} ({fl_l:.4e} flop, {nb_l} B), algorithmic bound "
          f"{n100['bound_algo_ms_n100']:.6f} ms; per block <= 3e-4 * max(1, |block|): "
          + ", ".join(f"{r[0]} {r[1]:.2e}/{r[2]:.2e}" for r in gate["all"][:5])
          + "; per part, worst err/bound with all groups and each alone: " + gate_summary(gate)
          + "; outside: " + (", ".join(gate_failures(gate)) or "none") + f" ({card})",
          flush=True)
    if gate_failures(gate):
        fail("lingram disagrees with its plain twin at B=256, N=100")
    F.rti_chain(sol_l, Xb, Ub, torch.zeros_like(pb.lam_eq), lam_ineq, pb, 1)   # warm-up
    (Xe, Ue, le, lie, costs, qpi), wall, ln = run_chain(sol_l, Xb, Ub, pb, lam_ineq,
                                                        LONG_STEPS)
    finite = all(bool(torch.isfinite(x).all()) for x in (Xe, Ue, le, lie, costs))
    print(f"[long horizon] B={B_LONG} N={sol_l.N} warm RTI chain, {LONG_STEPS} steps: "
          f"{B_LONG * LONG_STEPS / wall:.1f} solves/s ({card}; informational), mean cost "
          f"{float(costs[-1].mean()):.3f}, mean inner passes {float(qpi.float().mean()):.3f}, "
          f"finite {finite}, launches {ln}", flush=True)
    if not finite or Ue.shape != (B_LONG, 100, 30):
        fail("the long-horizon chain went non-finite or changed shape")
    if (min(ln[k] for k in ("lingram", "riccati_sweep_terminal", "forward_rollout",
                            "dyncore")) <= 0 or ln["riccati_rollout"] != 0):
        fail(f"the long-horizon chain did not take the split route: {ln}")
    launches["riccati_sweep_terminal"] = ln["riccati_sweep_terminal"]
    launches["forward_rollout"] = ln["forward_rollout"]

    pe = pb.replace(lam_eq=le, lam_ineq=lie)
    head, d, term, dx0 = step_args(sol_l, Xe, Ue, pe)
    h = head[2]
    blocks = lingram(sol_l.spec, sol_l.weights, Xe, Ue, pe, sol_l.opt.torque_limit_in_qp)
    a4 = (*head, *blocks, d, *term)
    g_k, g_p = riccati_sweep_terminal(*a4), riccati_sweep_terminal_plain(*a4)
    P_N, p_N = terminal_gram(head[0], head[1], head[4], *term)
    g64 = riccati_sweep_plain(h, head[3], *(x.double() for x in (*blocks, P_N, p_N, d)))
    err, ok, txt = step_gate(g_k, g_p, g64, h, d, dx0)
    record("riccati_sweep_terminal", "iterative_learning_nmpc_tpu_torch/csrc/riccati.cu",
           "iterative_learning_nmpc_tpu/ops/riccati_kernel.py:463", err, ok,
           f"B={B_LONG}, N=100: {txt}", cuda_time_ms(lambda: riccati_sweep_terminal(*a4), 20),
           cuda_time_ms(lambda: riccati_sweep_terminal_plain(*a4), 3),
           riccati_sweep_terminal_plain, a4, g_k)
    # kernel 5 at the chain's end state, and at B=512 (the 256 problems twice)
    a5 = (h, g_k, d, dx0)
    c5, out5 = rollout_case(a5, card)
    k5_shapes = {f"B={B_LONG} N=100": c5, f"B={2 * B_LONG} N=100": rollout_case(
        (h, *(torch.cat([x, x]) for x in (g_k, d, dx0))), card)[0]}
    ric_attrs = riccati_attributes()
    regs5, local5, blocks5 = ric_attrs["forward_rollout"]
    print(f"[forward_rollout] {regs5} registers, {local5} B local a thread, {blocks5} blocks "
          f"(one warp each) an SM ({card})", flush=True)
    if local5 > 0:
        fail(f"forward_rollout uses {local5} B of local memory a thread")
    record("forward_rollout", "iterative_learning_nmpc_tpu_torch/csrc/riccati.cu",
           "iterative_learning_nmpc_tpu/ops/riccati_kernel.py:650", c5["max_abs_err"],
           all(c["ok"] for c in k5_shapes.values()),
           f"rel |d(dU, dX)| / (1 + |plain|) <= {REL_GATE}, or to the float64 rollout <= 2 x "
           f"the twin's + {0.1 * REL_GATE:.0e}, at " + ", ".join(k5_shapes),
           c5["ms"], c5["plain_ms"], forward_rollout_plain, a5, out5,
           extra=dict(by_shape=k5_shapes, kernel_attributes={"forward_rollout": ric_attrs[
               "forward_rollout"]}))

    # the fused kernel against the split chain on the same blocks; both
    # timed on the first n nodes (terminal state X[:, n]) at each n
    for n in CUTOVER_NS:
        dn = d[:, :n].contiguous()
        an = (*head, *(x[:, :n].contiguous() for x in blocks), dn)
        tn = (Xe[:, n].contiguous(), pe.peak[:, :, n].contiguous(), *term[2:])
        fused = lambda: riccati_rollout(*an, dx0, *tn)
        split = lambda: forward_rollout(h, riccati_sweep_terminal(*an, *tn), dn, dx0)
        (fX, fU), (sX, sU) = fused(), split()
        r = max(rel(sU, fU), rel(sX, fX))
        same = bool(torch.equal(fU, sU) and torch.equal(fX, sX))
        ms_f, ms_s = cuda_time_ms(fused, 20), cuda_time_ms(split, 20)
        print(f"[cutover] B={B_LONG} N={n}: fused riccati_rollout {ms_f:.4f} ms, "
              f"riccati_sweep_terminal -> forward_rollout {ms_s:.4f} ms; split vs fused "
              f"rel {r:.2e} (<= 1e-5), bit-equal {same} ({card})", flush=True)
        if not (r <= 1e-5 and same):
            fail(f"the fused kernel and the split chain differ at N={n}: rel {r:.2e}, "
                 f"bit-equal {same}")

    B2 = g["x0_rti"].shape[0]
    p2 = p_l.map(lambda x: x.expand((B2,) + x.shape[1:]).contiguous())
    p2 = p2.replace(x0=t(g["x0_rti"]), lam_ineq=t(g["lam_ineq_conv"])[None].expand(
        B2, -1, -1).contiguous())
    s2 = sol_l.solve(Xc.repeat(B2, 1, 1), Uc.repeat(B2, 1, 1), p2, 1)
    du = rel(s2.U.cpu(), torch.as_tensor(g["U_rti"]))
    print(f"[long horizon vs JAX] B={B2} N=100 RTI step from the golden's converged "
          f"point: rel|dU| {du:.2e} (gate {REL_GATE})", flush=True)
    if not du <= REL_GATE:
        fail(f"the N=100 RTI step differs from the JAX golden by {du:.2e}")

    # ---- 15. the pallas + jacfwd route, N=25 ----
    opt_j = dataclasses.replace(solver.opt, linearize_mode="jacfwd", riccati_mode="pallas")
    sol_j = TrajOptSolver(solver.spec, opt_j, solver.cost, device=dev)
    Xb, Ub, pb = F.perturbed_batch(conv.X, conv.U, params, B_JACFWD, seed=SEED)
    lam_ineq = conv.lam_ineq.expand_as(pb.lam_ineq).contiguous()
    (Xe, Ue, le, lie, costs, qpi), wall, ln = run_chain(sol_j, Xb, Ub, pb, lam_ineq,
                                                        JACFWD_STEPS)
    finite = all(bool(torch.isfinite(x).all()) for x in (Xe, Ue, le, lie, costs))
    print(f"[jacfwd route] B={B_JACFWD} N={sol_j.N} warm RTI chain, {JACFWD_STEPS} steps: "
          f"{wall / JACFWD_STEPS * 1e3:.1f} ms per step ({card}; informational), mean cost "
          f"{float(costs[-1].mean()):.3f}, mean inner passes {float(qpi.float().mean()):.3f}, "
          f"finite {finite}, launches {ln}", flush=True)
    if not finite:
        fail("the jacfwd-route chain went non-finite")
    if (min(ln[k] for k in ("riccati_sweep", "forward_rollout", "dyncore")) <= 0
            or ln["lingram"] != 0 or ln["riccati_rollout"] != 0):
        fail(f"the jacfwd-route chain did not take its route: {ln}")
    launches["riccati_sweep"] = ln["riccati_sweep"]

    pe = pb.replace(lam_eq=le, lam_ineq=lie)
    head, d, term, dx0 = step_args(sol_j, Xe, Ue, pe)
    h = head[2]
    blocks = gn_blocks_jacfwd(sol_j.spec, sol_j.weights, Xe, Ue, pe,
                              include_torque=sol_j.opt.torque_limit_in_qp)
    a6 = (h, head[3], *blocks, *terminal_gram(sol_j.spec, sol_j.weights, head[4], *term), d)
    g_k, g_p = riccati_sweep(*a6), riccati_sweep_plain(*a6)
    g64 = riccati_sweep_plain(h, head[3], *(x.double() for x in a6[2:]))
    err, ok, txt = step_gate(g_k, g_p, g64, h, d, dx0)
    # kernel 5 at the jacfwd route's shape, on its gains; in kernel 5's line
    k5_shapes[f"B={B_JACFWD} N={sol_j.N}"] = rollout_case((h, g_k, d, dx0), card)[0]
    if not k5_shapes[f"B={B_JACFWD} N={sol_j.N}"]["ok"]:
        fail(f"forward_rollout disagrees with its plain twin at B={B_JACFWD}, N={sol_j.N}")
    record("riccati_sweep", "iterative_learning_nmpc_tpu_torch/csrc/riccati.cu",
           "iterative_learning_nmpc_tpu/ops/riccati_kernel.py:390", err, ok,
           f"B={B_JACFWD}, N={sol_j.N}: {txt}", cuda_time_ms(lambda: riccati_sweep(*a6), 20),
           cuda_time_ms(lambda: riccati_sweep_plain(*a6), 3), riccati_sweep_plain, a6, g_k,
           algo_flops=algo_flops_riccati(B_JACFWD, sol_j.N, rollout=False))

    Xg, Ug = (t(golden[k])[None] for k in ("X_conv", "U_conv"))
    s1 = sol_j.solve(Xg, Ug, params.replace(lam_ineq=t(golden["lam_ineq_conv"])[None]), 1)
    du = rel(s1.U[0].cpu(), torch.as_tensor(golden["U_rti"]))
    print(f"[jacfwd route vs JAX] B=1 N=25 RTI step from the golden's converged point: "
          f"rel|dU| {du:.2e} (gate {REL_GATE})", flush=True)
    if not du <= REL_GATE:
        fail(f"the jacfwd-route RTI step differs from the JAX golden by {du:.2e}")

    # ---- 16. the modes the port has not ported ----
    for mode in ("sequential", "associative"):
        try:
            TrajOptSolver(solver.spec, dataclasses.replace(solver.opt, riccati_mode=mode),
                          solver.cost, device=dev)
        except NotImplementedError:
            continue
        fail(f"riccati_mode={mode!r} did not raise NotImplementedError")
    print("[modes] riccati_mode 'sequential' and 'associative' raise "
          "NotImplementedError", flush=True)
    return n100


def policy_bf16_phase(dev, card, pp_args, fp32_times, kernels, record) -> None:
    """Phase 17: the policy served through make_fused_policy_pd with
    compute_dtype=bfloat16 (kernel 8b) on phase 10's observations at
    B = 256, 1000 (a ragged tile) and 4096, then seeded nets of widths
    (47, 132, 100, 260, 12) and (47, 1024, 1024, 1024, 12) at B=256
    (``BF16_WIDTHS``), counters set to 0 before the five calls: each
    against its plain twin and against fp32 serving (the fp32 kernel), the
    kernel's attributes at each shape, and the shipped net timed eagerly
    and by device time (CUDA-graph replay) beside the bf16 addmm chain on
    cuBLAS; the fp32 kernel's and chain's times are phase 10's
    (``fp32_times``)."""
    import torch

    from iterative_learning_nmpc_tpu_torch.interop import random_policy_payload
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        bf16_kernel_attributes, bf16_layers, fold_batchnorm, make_fused_policy_pd, policy_pd,
        policy_pd_bf16, policy_pd_bf16_plain, policy_pd_plain)
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    layers = pp_args[B_ENV][0]                    # the served fp32 layers, on dev
    fn = make_fused_policy_pd(layers, POLICY_KP, POLICY_KD, compute_dtype=torch.bfloat16,
                              device=dev)
    nets = {}
    for widths in BF16_WIDTHS:
        folded = fold_batchnorm(random_policy_payload(3, widths, sum(widths))["variables"])
        ls = [tuple(torch.as_tensor(t, device=dev) for t in l) for l in folded]
        nets[widths] = (ls, make_fused_policy_pd(ls, POLICY_KP, POLICY_KD,
                                                 compute_dtype=torch.bfloat16, device=dev))
    x256 = pp_args[B_ENV][3:]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    outs = {nb: fn(*a[3:]) for nb, a in pp_args.items()}
    outs.update({w: f(*x256) for w, (_, f) in nets.items()})
    torch.cuda.synchronize()
    n_launch = policy_pd_bf16.launches
    if n_launch != len(outs):
        fail(f"the bf16 factory launched policy_pd_bf16 {n_launch} times for {len(outs)} calls")
    bl = bf16_layers(layers, dev)
    w4 = bl[3][0][:, :bl[3][1].shape[0]].contiguous()

    def cublas_bf16(x, qj, vj):
        """The bf16 addmm chain on cuBLAS: layer 1 in fp32, layers 2-4 bf16
        in and out (cuBLAS sums in fp32), the PD step in fp32."""
        h = torch.relu(torch.addmm(bl[0][1], x, bl[0][0])).to(torch.bfloat16)
        for (W, b), relu in ((bl[1], True), (bl[2], True), ((w4, bl[3][1]), False)):
            h = torch.addmm(b.to(torch.bfloat16), h, W)
            h = torch.relu(h) if relu else h
        a = h.float()
        return a, POLICY_KP * (a - qj) - POLICY_KD * vj

    def held(key, ls, x, qj, vj, fp32):
        """(max error to the twin, within the gates, the gates' text): one
        bf16 ulp of the output scale against the twin, kp times that + 1e-3
        for tau; 2^-5 of it against fp32 serving (``fp32``)."""
        ak, tk = outs[key]
        ap, tp = policy_pd_bf16_plain(ls, POLICY_KP, POLICY_KD, x, qj, vj)
        af, _ = fp32(ls, POLICY_KP, POLICY_KD, x, qj, vj)
        scale = max(1.0, float(ap.abs().max()))
        e_a, e_t = float((ak - ap).abs().max()), float((tk - tp).abs().max())
        gap = float((ak - af).abs().max()) / scale
        # an fp32 summation-order difference can flip one bf16 rounding of an
        # activation at a later layer's input: one bf16 ulp of the output
        # scale, kp times that for tau; fp32 serving within the three
        # layers' bf16 roundings, 2^-5 of the output scale
        ok = (e_a <= BF16_ULP * scale and e_t <= POLICY_KP * BF16_ULP * scale + 1e-3
              and gap <= 2.0 ** -5)
        return max(e_a, e_t), ok, (f"vs twin |d act| {e_a:.3e} (<= {BF16_ULP * scale:.3e}), "
                                   f"|d tau| {e_t:.3e}; vs fp32 serving ({fp32.__name__}) "
                                   f"{gap:.3e} of the output scale (<= {2.0 ** -5:.3e})")

    def attrs_text(B, dims):
        at = bf16_kernel_attributes(B, dims, dev)
        return at, ", ".join(f"{k} {v}" for k, v in at.items())

    rows, attrs = {}, {}
    for nb, a in pp_args.items():
        x, qj, vj = a[3:]
        err, ok, txt = held(nb, layers, x, qj, vj, policy_pd)
        ms = cuda_time_ms(lambda: fn(x, qj, vj), 50)
        plain_ms = cuda_time_ms(lambda: policy_pd_bf16_plain(layers, POLICY_KP, POLICY_KD,
                                                             x, qj, vj), 20)
        chain16 = cuda_time_ms(lambda: cublas_bf16(x, qj, vj), 20)
        device_ms = graph_time_ms(lambda: fn(x, qj, vj))
        device_chain16 = graph_time_ms(lambda: cublas_bf16(x, qj, vj))
        rows[nb] = (err, ok, ms, plain_ms, chain16, device_ms, device_chain16, (x, qj, vj),
                    outs[nb])
        t32 = {k: v[nb] for k, v in fp32_times.items()}
        attrs[nb], at_txt = attrs_text(nb, [x.shape[1]] + [int(b.shape[0]) for _, b in layers])
        print(f"[policy_pd_bf16] B={nb}: {txt}; bf16 kernel {ms:.4f} ms (device "
              f"{device_ms:.4f}), twin {plain_ms:.4f} ms, bf16 addmm chain on cuBLAS "
              f"{chain16:.4f} ms (device {device_chain16:.4f}); phase 10's fp32 kernel "
              f"{t32['ms_by_batch']:.4f} ms (device {t32['device_ms_by_batch']:.4f}), fp32 chain "
              f"{t32['library_chain_ms']:.4f} ms (device {t32['device_chain_ms']:.4f}); "
              f"attributes: {at_txt} ({card})", flush=True)
    for widths, (ls, _) in nets.items():
        err, ok, txt = held(widths, ls, *x256, policy_pd)
        rows[widths] = (err, ok)
        padded = [int(b.shape[0]) for _, b in bf16_layers(ls, dev)]   # as the factory pads
        attrs[widths], at_txt = attrs_text(B_ENV, (47, *padded))
        print(f"[policy_pd_bf16] widths 47 -> {' -> '.join(map(str, widths))} -> 12, "
              f"B={B_ENV}: {txt}; attributes: {at_txt} ({card})", flush=True)
    (W1, _), (W2, _), (W3, _), (W4, b4) = bl
    n_in, h1, h2, h3, n_out = *W1.shape, W2.shape[1], W3.shape[1], b4.shape[0]

    def work_at(nb):
        """(fp32 flops, bf16 tensor-core flops, bytes) of the shipped net at
        batch nb: layer 1 in fp32, layers 2-4 on the tensor cores."""
        B, (x, qj, vj), out = nb, rows[nb][7], rows[nb][8]
        return (2.0 * B * n_in * h1, 2.0 * B * (h1 * h2 + h2 * h3 + h3 * n_out),
                distinct_bytes([x, qj, vj, *(t for l in bl for t in l), *out]))

    bounds = {nb: bound_of(*work_at(nb)) for nb in pp_args}
    print("[policy_pd_bf16] bound (layer 1 at 67 TFLOP/s fp32, layers 2-4 at 989 TFLOP/s bf16, "
          "the bytes at 3.35 TB/s): " + ", ".join(f"B={nb} {b:.6f} ms by {by}"
                                                  for nb, (b, by) in bounds.items()), flush=True)
    err, ok, ms, plain_ms, _, _, _, (x, qj, vj), out = rows[B_ENV]
    work = work_at(B_ENV)
    shapes = [f"B={nb}" for nb in pp_args] + [f"widths {w} at B={B_ENV}" for w in nets]
    record("policy_pd_bf16", "iterative_learning_nmpc_tpu_torch/csrc/policy_pd_bf16.cu",
           "iterative_learning_nmpc_tpu/ops/policy_kernel.py:65", max(r[0] for r in rows.values()),
           all(r[1] for r in rows.values()),
           "|d act| <= 2^-8 max(1, |act|), |d tau| <= kp 2^-8 max(1, |act|) + 1e-3 against the "
           "twin, |d act| <= 2^-5 max(1, |act|) against fp32 serving, at " + ", ".join(shapes),
           ms, plain_ms, None, None, out, n_launch=n_launch, work=work,
           extra={**{key: {nb: r[i] for nb, r in rows.items() if len(r) > 2} for i, key in
                     ((2, "ms_by_batch"), (4, "library_chain_ms"), (5, "device_ms_by_batch"),
                      (6, "device_chain_ms"))},
                  "bound_ms_by_batch": {nb: b for nb, (b, _) in bounds.items()},
                  "kernel_attributes": {str(k): v for k, v in attrs.items()}})


def ceiling_phase(dev, card, kernels, record):
    """Phase 18: fma_chain against its twin on a small shape, then at full
    size (the probe's constants a = 0.999, b = 1e-6, counters set to 0
    before its timed runs): the measured fp32 FMA rate; and the HBM rate of
    x + 1.0 over 1 GiB. Returns (TFLOP/s, GB/s)."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import probes
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    gen = torch.Generator().manual_seed(SEED)
    a_s = (0.5 + 0.5 * torch.rand(132 * 256, generator=gen)).to(dev)
    b_s = (0.05 + 0.85 * torch.rand(132 * 256, generator=gen)).to(dev)
    it, nacc = probes.FMA_ITERS, probes.FMA_NACC
    a = torch.full((probes.FMA_N,), 0.999, device=dev)
    b = torch.full((probes.FMA_N,), 1e-6, device=dev)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    ms = min(cuda_time_ms(lambda: probes.fma_chain(a, b, it, nacc), 10) for _ in range(3))
    n_launch = probes.fma_chain.launches
    out = probes.fma_chain(a, b, it, nacc)
    ref = probes.fma_chain_plain(a, b, it, nacc)
    small = probes.fma_chain(a_s, b_s, 64, nacc)
    ref_s = probes.fma_chain_plain(a_s, b_s, 64, nacc)
    # one rounding per FMA against two per step in the twin; |b| < 1 damps
    # the difference: 1e-5 of the value
    rel_f = float(((out - ref).abs() / ref.abs()).max())
    rel_s = float(((small - ref_s).abs() / ref_s.abs()).max())
    plain_ms = cuda_time_ms(lambda: probes.fma_chain_plain(a, b, it, nacc), 1)
    flops = probes.fma_chain_flops(probes.FMA_N, it, nacc)
    tf = flops / (ms * 1e-3) / 1e12
    x = torch.ones(256 * 1024 * 1024, device=dev)     # 1 GiB of fp32
    t_bw = min(cuda_time_ms(lambda: x + 1.0, 10) for _ in range(3))
    bw = 2.0 * x.numel() * 4 / (t_bw * 1e-3) / 1e9
    del x
    print(f"[ceilings] fp32 FMA {tf:.3f} TFLOP/s ({ms:.4f} ms for {flops:.4e} flop, n "
          f"{probes.FMA_N}, {it} steps x {nacc} chains; {tf / (PEAK_FLOPS / 1e12):.4f} of the "
          f"nominal 67), HBM {bw:.1f} GB/s (x + 1.0 over 1 GiB: {t_bw:.4f} ms; "
          f"{bw / (PEAK_BYTES / 1e9):.4f} of the nominal 3350) ({card})", flush=True)
    record("fma_chain", "iterative_learning_nmpc_tpu_torch/csrc/probes.cu",
           "scripts/roofline.py:133", max(float((out - ref).abs().max()),
                                          float((small - ref_s).abs().max())),
           rel_f <= 1e-5 and rel_s <= 1e-5,
           f"rel {rel_s:.2e} at n = {a_s.numel()}, 64 steps (random a, b), {rel_f:.2e} at full "
           f"size, <= 1e-5", ms, plain_ms, None, None, out, n_launch=n_launch,
           work=(flops, 0.0, 12 * probes.FMA_N))
    return tf, bw


def node_solve_phase(dev, card, kernels, record) -> None:
    """Phase 19: the node solve's three thread mappings on the reference
    probe's blocks at B=1024, N=25, counters set to 0 before the three calls:
    each against node_solve_plain and the block mapping, then timed there and
    at B=256 (the sweep's batch)."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import probes
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    def case(B):
        blocks = probes.reference_node_blocks(B, NODE_N, SEED, dev)
        laid = [probes.lay_batch_inner(t, t.dim() - 2) for t in blocks]
        return blocks, {"block": lambda: probes.node_solve_block(*blocks),
                        "warp": lambda: probes.node_solve_warp(*blocks),
                        "thread": lambda: probes.node_solve_thread(*laid)}

    blocks, calls = case(NODE_B)
    fns = {m: getattr(probes, f"node_solve_{m}") for m in calls}
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    outs = {m: c() for m, c in calls.items()}
    torch.cuda.synchronize()
    n_launch = {m: f.launches for m, f in fns.items()}
    outs["thread"] = [probes.unlay_batch_inner(o, (NODE_B, NODE_N)) for o in outs["thread"]]
    ref = probes.node_solve_plain(*blocks)
    rel = lambda xs, ys: max(float((x - y).abs().max()) / float(y.abs().max())
                             for x, y in zip(xs, ys))
    M = NODE_B * NODE_N
    work = (probes.node_solve_flops(M), 0.0, probes.node_solve_bytes(M))
    plain_ms = cuda_time_ms(lambda: probes.node_solve_plain(*blocks), 5)
    times = {m: cuda_time_ms(c, 20) for m, c in calls.items()}
    _, calls_s = case(NODE_B_SWEEP)
    times_s = {m: cuda_time_ms(c, 20) for m, c in calls_s.items()}
    for m, out in outs.items():
        r_p, r_b = rel(out, ref), rel(out, outs["block"])
        print(f"[node solve] {m}: B={NODE_B} N={NODE_N} {times[m]:.4f} ms "
              f"({M / times[m] * 1e3:.1f} node-solves/s, {times['block'] / times[m]:.3f}x the "
              f"block mapping), B={NODE_B_SWEEP} {times_s[m]:.4f} ms "
              f"({NODE_B_SWEEP * NODE_N / times_s[m] * 1e3:.1f} node-solves/s); rel to the twin "
              f"{r_p:.2e}, to the block mapping {r_b:.2e} (<= {NODE_REL:.0e}) ({card})",
              flush=True)
        err = max(float((x - y).abs().max()) for x, y in zip(out, ref))
        record(f"node_solve_{m}", "iterative_learning_nmpc_tpu_torch/csrc/probes.cu",
               "scripts/proto_sublane_riccati.py:70" if m == "block"
               else "scripts/proto_sublane_riccati.py:179", err,
               r_p <= NODE_REL and r_b <= NODE_REL,
               f"max |d| / max |twin| per output {r_p:.2e} <= {NODE_REL:.0e} (Quu = G G^T + 3 I)",
               times[m], plain_ms, None, None, out, n_launch=n_launch[m], work=work)
        if n_launch[m] != 1:
            fail(f"node_solve_{m} launched {n_launch[m]} times for one call")


def bc_gate(a, b, const_cols):
    """Two one-epoch runs from the same payload, each (per-step losses,
    Flax-layout variables): (within the gate, the worst relative loss gap,
    the worst parameter gap, the worst gap of the noisy ones, as
    ``learning.train.trained_gaps`` splits them)."""
    import numpy as np

    from iterative_learning_nmpc_tpu_torch.learning.train import trained_gaps

    (la, va), (lb, vb) = a, b
    loss_gap = float(np.max(np.abs(la / lb - 1.0)))
    worst, worst_noisy = trained_gaps(va, vb, const_cols)
    ok = loss_gap <= BC_LOSS_RTOL and worst <= BC_PARAM_ATOL and worst_noisy <= BC_NOISY_ATOL
    return ok, loss_gap, worst, worst_noisy


def training_phases(dev, card, spec_d, datagen_rows, kernels) -> None:
    """Phases 20-21: behaviour cloning on phase 12's rows at full width
    (timed, held to the same epoch on the CPU, the trained payload served by
    kernel 8), then the on-device SafeDAgger loop at B_ENV envs with the
    counters set to 0 before each collect and read after it."""
    import copy
    import dataclasses
    import pickle
    import tempfile

    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.interop import random_policy_payload
    from iterative_learning_nmpc_tpu_torch.learning.dagger import (
        OnDeviceSafeDagger, SafeDaggerConfig)
    from iterative_learning_nmpc_tpu_torch.learning.database import Database
    from iterative_learning_nmpc_tpu_torch.learning.network import (
        FlaxBatchNorm, ServedPolicy, load_policy, save_policy)
    from iterative_learning_nmpc_tpu_torch.learning.train import BehavioralCloning, TrainConfig
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd, policy_pd_dense

    rows, vd = datagen_rows
    B, T = rows.valid.shape
    keep = (rows.valid > 0.5).reshape(-1)
    keep_np = keep.cpu().numpy()
    db = Database(limit=int(keep_np.sum()), goal_type="vc")
    db.append(rows.state44.reshape(-1, 44)[keep].cpu().numpy(),
              rows.action.reshape(-1, 12)[keep].cpu().numpy(),
              vc_goals=np.repeat(vd, T, axis=0)[keep_np],
              traj_id=np.repeat(np.arange(B), T)[keep_np],
              times=np.tile(np.arange(T) * 1e-3, B)[keep_np])
    # phase 10's observations at B_ENV: each env's last datagen row
    s44, goal = rows.state44[:, -1].contiguous(), torch.as_tensor(vd, device=dev)
    qj, vj = rows.q[:, -1, 6:].contiguous(), rows.v[:, -1, 6:].contiguous()

    def served_check(path, name):
        """The payload reloaded and served: (route, kernel 8 launches,
        max_abs_err to the net's float64 eval-mode forward, within kernel
        8's bound)."""
        net, norm = load_policy(path, device=dev)
        served = ServedPolicy(net, norm, device=dev)
        n0 = (policy_pd.launches, policy_pd_dense.calls)
        act, tau = served(s44, goal, qj, vj, POLICY_KP, POLICY_KD)
        torch.cuda.synchronize()
        n1 = (policy_pd.launches - n0[0], policy_pd_dense.calls - n0[1])
        with torch.no_grad():
            ref = copy.deepcopy(net).double()(served.normalize(s44, goal).double())
        tau_ref = POLICY_KP * (ref - qj.double()) - POLICY_KD * vj.double()
        act, tau = act.double(), tau.double()
        err = max(float((act - ref).abs().max()), float((tau - tau_ref).abs().max()))
        ok = bool(((act - ref).abs() <= 2e-5 + 2e-4 * ref.abs()).all()
                  and ((tau - tau_ref).abs() <= 1e-3 + 2e-4 * tau_ref.abs()).all())
        print(f"[{name} served] {os.path.basename(path)}: route {served.route}, kernel 8 "
              f"launches {n1[0]}, dense calls {n1[1]}, B={B}: max_abs_err to the net's float64 "
              f"eval-mode forward {err:.3e} ({'within' if ok else 'OUTSIDE'} |d act| <= 2e-5 + "
              f"2e-4 |act|, |d tau| <= 1e-3 + 2e-4 |tau|; {card})", flush=True)
        if served.route != "kernel" or n1 != (1, 0) or not ok:
            fail(f"{name}: the trained payload was not served by kernel 8 within its bound "
                 f"(route {served.route}, calls {n1})")
        return net

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 20. behaviour cloning at full width ----
        t20 = time.perf_counter()
        cfg = TrainConfig(n_epochs=BC_EPOCHS, save_dir=os.path.join(tmp, "bc"), run_name="smoke")
        bc = BehavioralCloning(cfg, device=dev)
        final = bc.run(db)
        torch.cuda.synchronize()
        walls = np.diff([0.0] + [m["wall"] for m in bc.metrics])
        n_steps = len(bc.step_losses[0])
        for m, w in zip(bc.metrics, walls):
            print(f"[bc] {len(db)} rows (phase 12's valid rows), epoch {m['epoch']}: train loss "
                  f"{m['train_loss']:.6f}, val loss {m['val_loss']:.6f}; {m['step_ms']:.4f} ms a "
                  f"training step (CUDA events over {n_steps} steps of {cfg.batch_size} rows), "
                  f"{cfg.batch_size / m['step_ms'] * 1e3:.1f} rows/s; epoch wall {w:.3f} s "
                  f"({card})", flush=True)
        losses = [m[k] for m in bc.metrics for k in ("train_loss", "val_loss")]
        if not (np.isfinite(losses).all()
                and bc.metrics[-1]["train_loss"] < bc.metrics[0]["train_loss"]):
            fail(f"BC losses non-finite or not falling: {losses}")

        # one epoch from the trained payload on the card and on the CPU
        pick = np.arange(0, len(db), max(1, len(db) // BC_CMP_ROWS))[:BC_CMP_ROWS]
        sub = Database(limit=len(pick), goal_type="vc")
        sub.append(db.states_array()[pick], db.actions_array()[pick],
                   vc_goals=db.goals_array()[pick])
        X_sub, Y_sub = sub.training_arrays()
        const_cols = np.flatnonzero(X_sub.std(axis=0) == 0.0)

        class OneIndexChanged(BehavioralCloning):
            """The first batch's first row swapped for the train row whose
            action is furthest from it."""

            def draw_batches(self, rng, train_idx, p_train, n_batches):
                idx = super().draw_batches(rng, train_idx, p_train, n_batches)
                i = idx[0, 0]
                idx[0, 0] = train_idx[np.abs(Y_sub[train_idx] - Y_sub[i]).sum(axis=1).argmax()]
                return idx

        class StaleMeans(BehavioralCloning):
            """The running means kept at momentum 0.99 (Flax's is 0.9): a
            fault that only the noisy leaves carry."""

            def run(self, *args, **kwargs):
                forward = FlaxBatchNorm.forward

                def stale(bn, x):
                    mean = bn.running_mean.clone()
                    out = forward(bn, x)
                    if bn.training:
                        with torch.no_grad():
                            bn.running_mean.copy_(0.99 * mean + 0.01 * x.mean(0))
                    return out

                FlaxBatchNorm.forward = stale
                try:
                    return super().run(*args, **kwargs)
                finally:
                    FlaxBatchNorm.forward = forward

        def one_epoch(name, cls, d, seed):
            c = dataclasses.replace(cfg, n_epochs=1, seed=seed,
                                    save_dir=os.path.join(tmp, f"{name}{seed}"), run_name="cmp")
            b = cls(c, device=d)
            t0 = time.perf_counter()
            path = b.run(sub, warm_start_path=final)
            wall = time.perf_counter() - t0
            with open(path, "rb") as f:
                return (b.step_losses[0].astype(np.float64), pickle.load(f)["variables"]), wall

        readings = []
        for seed in range(BC_CMP_SEEDS):
            (on_card, w_card), (on_cpu, w_cpu) = (one_epoch(name, BehavioralCloning, d, seed)
                                                  for name, d in (("cuda", dev), ("cpu", "cpu")))
            ok, gap, worst, worst_noisy = bc_gate(on_card, on_cpu, const_cols)
            readings.append((gap, worst, worst_noisy))
            print(f"[bc card vs cpu] seed {seed}: one epoch of {len(on_card[0])} steps on "
                  f"{len(sub)} rows ({w_card:.3f} s on the card, {w_cpu:.3f} s on the CPU): "
                  f"per-step losses worst |l_card / l_cpu - 1| {gap:.3e} (<= {BC_LOSS_RTOL:.0e}), "
                  f"parameters {worst:.3e} (<= {BC_PARAM_ATOL:.0e}), the noisy ones (pre-BatchNorm "
                  f"biases, running means, constant inputs' rows {const_cols.tolist()}) "
                  f"{worst_noisy:.3e} (<= {BC_NOISY_ATOL:.1e}): {'held' if ok else 'FAILED'} "
                  f"({card})", flush=True)
            if seed == 0:
                control = on_card
            if not ok:
                fail(f"BC on the card disagrees with the port on the CPU (seed {seed})")
        for name, cls in (("one batch index changed", OneIndexChanged),
                          ("running means at momentum 0.99", StaleMeans)):
            ok_c, gap_c, worst_c, noisy_c = bc_gate(control, one_epoch(name[:3], cls, "cpu", 0)[0],
                                                    const_cols)
            print(f"[bc card vs cpu] control, seed 0 with {name} on the CPU: losses {gap_c:.3e}, "
                  f"parameters {worst_c:.3e}, noisy {noisy_c:.3e}: "
                  f"{'held (the gate is blind)' if ok_c else 'fails, as it must'}", flush=True)
            if ok_c:
                fail(f"the BC gate does not see {name}")
        print("[bc card vs cpu] largest over seeds: losses %.3e, parameters %.3e, noisy %.3e"
              % tuple(np.max(readings, axis=0)), flush=True)
        served_check(final, "bc")
        wall20 = time.perf_counter() - t20

        # ---- 21. the on-device SafeDAgger loop at full width ----
        t21 = time.perf_counter()
        payload = random_policy_payload(3, 512, SEED)
        policy0 = save_policy(os.path.join(tmp, "policy0.pkl"), payload["variables"], None,
                              payload["net_config"])
        dcfg = SafeDaggerConfig(
            record_dir=os.path.join(tmp, "dagger"), sim_time=DAGGER_SIM_S,
            delay_steps=DELAY_STEPS, mpc_min_steps=MPC_MIN_STEPS, goals=((V_DES, 0.0, 0.0),),
            n_iterations_per_goal=DAGGER_ITERS, n_epochs=DAGGER_EPOCHS,
            batch_size=DAGGER_BATCH, learning_rate=DAGGER_LR, seed=SEED)
        pipe = OnDeviceSafeDagger(spec_d, dcfg, policy0, batch=B_ENV, device=dev)
        T_d = pipe.n_intervals * 40                 # 40 control steps an interval
        steps = []
        collect, run_training = pipe.collect, pipe.run_training

        def timed_collect(policy_path, v_des, prev, tag):
            for k in kernels:
                k.launches = 0
            policy_pd_dense.calls = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = collect(policy_path, v_des, prev, tag)
            torch.cuda.synchronize()
            steps.append(dict(tag=tag, collect_s=time.perf_counter() - t0, path=path,
                              launches={k.__name__: k.launches for k in kernels},
                              dense=policy_pd_dense.calls, train_s=None))
            return path

        def timed_training(path, tag):
            t0 = time.perf_counter()
            out = run_training(path, tag)
            torch.cuda.synchronize()
            steps[-1]["train_s"] = time.perf_counter() - t0
            return out

        pipe.collect, pipe.run_training = timed_collect, timed_training
        final_d = pipe.run()
        sizes = []
        for st in steps:
            d = Database(limit=dcfg.database_size)
            d.load(st["path"])
            sizes.append(len(d))
        kept = np.diff([0] + sizes)
        for i, (st, ratio) in enumerate(zip(steps, pipe.expert_ratio_history)):
            ln = st["launches"]
            print(f"[dagger] iteration {i} ({st['tag']}): B={B_ENV} x {pipe.n_intervals} "
                  f"intervals ({T_d} control steps), expert ratio {ratio:.4f}, rows kept "
                  f"{kept[i]} (aggregate {sizes[i]}); collect {st['collect_s']:.2f} s wall "
                  f"({st['collect_s'] / T_d * 1e3:.3f} ms a control step), train "
                  f"{st['train_s']:.2f} s wall ({dcfg.n_epochs} epochs, batch {dcfg.batch_size}); "
                  f"launches dyncore {ln['dyncore']}, lingram {ln['lingram']}, riccati_rollout "
                  f"{ln['riccati_rollout']}, policy_pd {ln['policy_pd']}, dense calls "
                  f"{st['dense']} ({card})", flush=True)
            if min(ln[k] for k in ("dyncore", "lingram", "riccati_rollout")) <= 0:
                fail(f"DAgger collect {i} did not launch kernels 1-3: {ln}")
            if ln["policy_pd"] != T_d or st["dense"] != 0:
                fail(f"DAgger collect {i} launched kernel 8 {ln['policy_pd']} times (not once a "
                     f"control step, {T_d}) or took the dense route ({st['dense']} calls)")
        if len(pipe.expert_ratio_history) != DAGGER_ITERS or len(steps) != DAGGER_ITERS:
            fail(f"DAgger ran {len(steps)} data steps, not {DAGGER_ITERS}")
        if not pipe.expert_ratio_history[0] > 0.3:
            fail(f"DAgger: the expert ratio {pipe.expert_ratio_history[0]:.4f} <= 0.3 under the "
                 "untrained policy")
        if not sizes[1] > sizes[0] > 0:
            fail(f"DAgger: the aggregate did not grow: {sizes}")
        with open(final_d, "rb") as f:
            trained = pickle.load(f)["variables"]["params"]["Dense_0"]["kernel"]
        if final_d == policy0 or np.array_equal(
                trained, np.asarray(payload["variables"]["params"]["Dense_0"]["kernel"],
                                    np.float32)):
            fail("DAgger: the final payload is the initial one")
        served_check(final_d, "dagger")
        wall21 = time.perf_counter() - t21
    print(f"[training phases] phase 20 (BC) {wall20:.1f} s, phase 21 (SafeDAgger) "
          f"{wall21:.1f} s wall ({card})", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import numpy as np

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.interop import (
        sim_state_from_numpy, warm_start_from_numpy)
    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore, dyncore_plain
    from iterative_learning_nmpc_tpu_torch.ops.dyncore import (
        kernel_attributes as dyncore_attributes)
    from iterative_learning_nmpc_tpu_torch.ops.dynjac import (
        dynjac, dynjac_plain, structural_zeros)
    from iterative_learning_nmpc_tpu_torch.ops.dynjac import (
        kernel_attributes as dynjac_attributes)
    from iterative_learning_nmpc_tpu_torch.ops.lingram import (
        gate_failures, gate_summary, gram_gate, kernel_attributes, lingram, lingram_plain)
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd, policy_pd_bf16
    from iterative_learning_nmpc_tpu_torch.ops.probes import (
        algo_flops_dyncore, algo_flops_lingram, algo_flops_riccati, fma_chain, node_solve_block,
        node_solve_thread, node_solve_warp)
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        forward_rollout, riccati_rollout, riccati_rollout_plain, riccati_sweep,
        riccati_sweep_terminal)
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        kernel_attributes as riccati_attributes)
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim
    from iterative_learning_nmpc_tpu_torch.solver.linearize import dyncore_inputs
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    t_start = time.perf_counter()
    kernels = (dyncore, lingram, riccati_rollout, dynjac, policy_pd,
               riccati_sweep_terminal, forward_rollout, riccati_sweep, policy_pd_bf16,
               fma_chain, node_solve_block, node_solve_warp, node_solve_thread)

    dev = torch.device("cuda", 0)

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] kernels built from csrc/ in {time.perf_counter() - t0:.2f} s "
          f"({lib.name})", flush=True)

    # ---- 3. converged flagship solve vs the anchor and the JAX golden ----
    solver, X, U, params = F.flagship(device=dev)
    golden = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_n25_golden.npz"))
    dx0 = float(np.abs(params.x0[0].cpu().numpy() - golden["x0"]).max())
    if dx0 > 1e-6:
        fail(f"flagship x0 differs from the golden instance by {dx0:.2e}")
    conv = solver.solve(X, U, params, 15)
    cost = float(conv.stats.cost[0])
    with open(os.path.join(ROOT, "BENCH_ANCHOR.json")) as f:
        anchor = json.load(f)
    ref_cost, tol = float(anchor["converged_cost_cpu"]), float(anchor["tol_rel"])
    du_conv = rel(conv.U[0].cpu(), torch.as_tensor(golden["U_conv"]))
    Xg, Ug, _, lig = warm_start_from_numpy(golden["X_conv"], golden["U_conv"],
                                           golden["U_conv"][:, :18],
                                           golden["lam_ineq_conv"], device=dev)
    rti = solver.solve(Xg, Ug, params.replace(lam_ineq=lig), 1)
    du_rti = rel(rti.U[0].cpu(), torch.as_tensor(golden["U_rti"]))
    print(f"[flagship] 15-iteration B=1 solve: cost {cost:.4f} (anchor "
          f"{ref_cost} +- {tol:.0%}), rel|dU| vs JAX-CPU golden {du_conv:.2e}; "
          f"RTI step from the golden point rel|dU| {du_rti:.2e}", flush=True)
    if not abs(cost / ref_cost - 1.0) <= tol:
        fail(f"converged cost {cost} outside the anchor band")
    if not (du_conv <= REL_GATE and du_rti <= REL_GATE):
        fail(f"port vs golden rel|dU| {du_conv:.2e} / {du_rti:.2e} > {REL_GATE}")

    # ---- 4. the main path: B=512 warm RTI chain with dual carry-over ----
    Xb, Ub, pb = F.perturbed_batch(conv.X, conv.U, params, BATCH, seed=SEED)
    lam_eq = torch.zeros_like(pb.lam_eq)
    lam_ineq = conv.lam_ineq.expand_as(pb.lam_ineq).contiguous()
    F.rti_chain(solver, Xb, Ub, lam_eq, lam_ineq, pb, 1)        # warm-up
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xe, Ue, le, lie, costs, qpi = F.rti_chain(solver, Xb, Ub, lam_eq, lam_ineq,
                                              pb, CHAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in (dyncore, lingram, riccati_rollout)}
    finite = all(bool(torch.isfinite(t).all()) for t in (Xe, Ue, le, lie, costs))
    print(f"[main path] B={BATCH} N={solver.N} warm RTI chain, {CHAIN_STEPS} steps: "
          f"{BATCH * CHAIN_STEPS / dt:.1f} solves/s ({card}; informational), "
          f"mean cost {float(costs[-1].mean()):.3f}, mean inner passes "
          f"{float(qpi.float().mean()):.3f}, finite {finite}, launches {launches}",
          flush=True)
    if not finite:
        fail("non-finite values in the RTI chain")
    if Xe.shape != (BATCH, solver.N + 1, 36) or Ue.shape != (BATCH, solver.N, 30):
        fail(f"unexpected chain output shapes {tuple(Xe.shape)} {tuple(Ue.shape)}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")

    # ---- 5. each kernel against its plain twin, at the chain's shapes ----
    pe = pb.replace(lam_eq=le, lam_ineq=lie)
    spec, w = solver.spec, solver.weights
    results, counts = [], {}

    def record(name, src, replaces, err, ok, tol, ms, plain_ms, plain_fn, args, out,
               n_launch=None, work=None, algo_flops=None, extra=None):
        """Add a kernel's line. Its bound counts the plain twin's operations
        on these inputs, or ``work`` = (fp32 flops, bf16 tensor-core flops,
        bytes) where the twin's operations are not the kernel's work;
        ``algo_flops`` (a hand count of the minimal work) adds
        bound_algo_ms over the same bytes."""
        if work is None:
            _, _, flops, nbytes = bound(plain_fn, args, out)
            work = (flops, 0.0, nbytes)
        counts[name] = work
        b_ms, b_by = bound_of(*work)
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=launches[name] if n_launch is None else n_launch,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, **(extra or {}))
        algo = ""
        if algo_flops is not None:
            entry["bound_algo_ms"] = bound_of(algo_flops, 0.0, work[2])[0]
            algo = f", algorithmic bound {entry['bound_algo_ms']:.6f} ms ({algo_flops:.4e} flop)"
        tc = f" + {work[1]:.4e} bf16 flop" if work[1] else ""
        print(f"[kernel] {name}: max_abs_err {err:.3e} ({tol}), "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms by "
              f"{b_by} ({work[0]:.4e} flop{tc}, {work[2]} B){algo}", flush=True)
        results.append(entry)
        if not ok:
            fail(f"{name} disagrees with its plain twin ({tol})")

    N = solver.N
    inc = solver.opt.torque_limit_in_qp
    # lingram at the chain's first step: at a converged point the gradient
    # blocks qx, ru are ~0 sums of large cancelling terms (e.g. w_dyn^2 * m_tot
    # times one ulp of the 150 N base force), so a bound relative to |block|
    # measures nothing there; the converged state's blocks are held through
    # the riccati and full-step checks below
    ps = pb.replace(lam_eq=lam_eq, lam_ineq=lam_ineq)
    blocks_k = lingram(spec, w, Xb, Ub, ps, inc)
    # tests/test_fast_linearize.py's bound, 3e-4 * max(1, |part|), per part of
    # each block, with every row group on and with each row group alone; a
    # part may instead be no further from the float64 twin than twice the
    # fp32 twin (ops/lingram.gram_gate); the whole blocks meet the bound
    gate = gram_gate(lingram, spec, w, Xb, Ub, ps, inc)
    attrs = kernel_attributes()
    print("[lingram] registers and local bytes (stack and spills) a thread: "
          + "; ".join(f"{k} {r}, {lb} B" for k, (r, lb) in attrs.items()), flush=True)
    record("lingram", "iterative_learning_nmpc_tpu_torch/csrc/lingram.cu",
           "iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:698",
           max(r[1] for r in gate["all"]), not gate_failures(gate),
           "per block <= 3e-4 * max(1, |block|): "
           + ", ".join(f"{r[0]} {r[1]:.2e}/{r[2]:.2e}" for r in gate["all"][:5])
           + "; per part, worst err/bound with all groups and each alone: "
           + gate_summary(gate) + "; outside: " + (", ".join(gate_failures(gate)) or "none"),
           cuda_time_ms(lambda: lingram(spec, w, Xb, Ub, ps, inc), 20),
           cuda_time_ms(lambda: lingram_plain(spec, w, Xb, Ub, ps, inc), 3),
           lingram_plain, (spec, w, Xb, Ub, ps, inc), blocks_k,
           algo_flops=algo_flops_lingram(BATCH, N),
           extra=dict(kernel_attributes=attrs))
    blocks_k = lingram(spec, w, Xe, Ue, pe, inc)

    defects = solver._defects(Xe, Ue, pe)
    ric_args = (spec, w, solver.dt_nodes, float(solver.opt.lm_reg),
                float(solver.cost.reg_eps_e), *blocks_k, defects, pe.x0 - Xe[:, 0],
                Xe[:, -1], pe.peak[:, :, -1], pe.base_ref_e, pe.joint_ref,
                pe.step_height)
    dX_k, dU_k = riccati_rollout(*ric_args)
    dX_p, dU_p = riccati_rollout_plain(*ric_args)
    r_ric = max(rel(dU_k, dU_p), rel(dX_k, dX_p))
    # one problem of the same state: the closed loop's replan shape
    ric_b1 = tuple(a[:1].contiguous() if isinstance(a, torch.Tensor) else a for a in ric_args)
    r_b1 = max(rel(a, b) for a, b in zip(riccati_rollout(*ric_b1), riccati_rollout_plain(*ric_b1)))
    b1 = dict(rel_b1=r_b1, ms_b1=cuda_time_ms(lambda: riccati_rollout(*ric_b1), 50),
              plain_ms_b1=cuda_time_ms(lambda: riccati_rollout_plain(*ric_b1), 3))
    ric_attrs = riccati_attributes()
    print(f"[riccati] B=1 N={N}: {b1['ms_b1']:.4f} ms vs plain {b1['plain_ms_b1']:.4f} ms, "
          f"rel {r_b1:.2e}; registers, local bytes (stack and spills) a thread and resident "
          "blocks an SM: " + "; ".join(f"{k} {r}, {lb} B, {nb}"
                                        for k, (r, lb, nb) in ric_attrs.items()) + f" ({card})",
          flush=True)
    record("riccati_rollout", "iterative_learning_nmpc_tpu_torch/csrc/riccati.cu",
           "iterative_learning_nmpc_tpu/ops/riccati_kernel.py:202",
           max(float((dU_k - dU_p).abs().max()), float((dX_k - dX_p).abs().max())),
           r_ric <= REL_GATE and r_b1 <= REL_GATE,
           f"rel |d(dU, dX)| / (1 + |plain|) {r_ric:.2e}, at B=1 {r_b1:.2e}, <= {REL_GATE}",
           cuda_time_ms(lambda: riccati_rollout(*ric_args), 20),
           cuda_time_ms(lambda: riccati_rollout_plain(*ric_args), 3),
           riccati_rollout_plain, ric_args, (dX_k, dU_k), algo_flops=algo_flops_riccati(BATCH, N),
           extra=dict(b1, kernel_attributes=ric_attrs))

    # dyncore on the line-search candidates (alphas 1, 0.25): M = 2 * 512 * 26
    alphas = torch.tensor(solver.opt.ls_alphas_steady, device=dev)
    nA = len(alphas)
    Xc = (Xe[None] + alphas[:, None, None, None] * dX_k[None]).reshape(-1, N + 1, 36)
    Uc = (Ue[None] + alphas[:, None, None, None] * dU_k[None]).reshape(-1, N, 30)
    pc = pe.map(lambda t: t.repeat((nA,) + (1,) * (t.dim() - 1)))
    Xm, Am, Fm = (t.contiguous() for t in dyncore_inputs(Xc, Uc, pc))
    out_k, out_p = dyncore(spec, Xm, Am, Fm), dyncore_plain(spec, Xm, Am, Fm)
    # the two reassociate fp32 sums differently (the kernel sums the four
    # legs' wrenches across lanes): 1e-5 of the output scale
    err_dc = float((out_k - out_p).abs().max())
    bound_dc = 1e-5 * max(1.0, float(out_p.abs().max()))
    # the same at the shapes of its other paths: the B=1 replan, the B=256
    # datagen, the N=100 chain (the candidates' rows, repeated past M=26,624)
    rows = [torch.cat([t, t]) for t in (Xm, Am, Fm)]
    dc_by_m = {}
    for M in DYNCORE_MS:
        a = (spec, *(t[:M].contiguous() for t in rows))
        ref = dyncore_plain(*a)
        e = float((dyncore(*a) - ref).abs().max())
        dc_by_m[M] = dict(ms=cuda_time_ms(lambda a=a: dyncore(*a), 50),
                          device_ms=graph_time_ms(lambda a=a: dyncore(*a)), max_abs_err=e,
                          ok=e <= 1e-5 * max(1.0, float(ref.abs().max())))
    dc_attrs = dyncore_attributes()
    regs, local, blocks = dc_attrs["dyncore_kernel"]
    print(f"[dyncore] {regs} registers, {local} B local a thread, {blocks} blocks an SM; "
          + ", ".join(f"M={M} {r['ms']:.4f} ms eager, {r['device_ms']:.4f} device, err "
                      f"{r['max_abs_err']:.2e}{'' if r['ok'] else ' OUTSIDE'}"
                      for M, r in dc_by_m.items()) + f" ({card})", flush=True)
    if local > 0:
        fail(f"dyncore uses {local} B of local memory a thread")
    record("dyncore", "iterative_learning_nmpc_tpu_torch/csrc/dyncore.cu",
           "iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:599", err_dc,
           err_dc <= bound_dc and all(r["ok"] for r in dc_by_m.values()),
           f"<= 1e-5 * max(1, |out|) = {bound_dc:.3e}, M={Xm.shape[0]}; also at M = "
           + ", ".join(map(str, DYNCORE_MS)),
           cuda_time_ms(lambda: dyncore(spec, Xm, Am, Fm), 50),
           cuda_time_ms(lambda: dyncore_plain(spec, Xm, Am, Fm), 5),
           dyncore_plain, (spec, Xm, Am, Fm), out_k, algo_flops=algo_flops_dyncore(Xm.shape[0]),
           extra=dict(kernel_attributes=dc_attrs, by_M=dc_by_m))

    # ---- 6. one RTI step: kernel path vs plain path, both on the card ----
    class PlainSolver(TrajOptSolver):
        lingram = staticmethod(lingram_plain)
        dynjac = staticmethod(dynjac_plain)
        riccati_rollout = staticmethod(riccati_rollout_plain)
        dyncore = staticmethod(dyncore_plain)

    plain = PlainSolver(solver.spec, solver.opt, solver.cost, device=dev)
    s_k = solver.solve(Xe, Ue, pe, 1)
    s_p = plain.solve(Xe, Ue, pe, 1)
    r_step = rel(s_k.U, s_p.U)
    print(f"[rti step] B={BATCH} kernel path vs plain path on the card: rel|dU| "
          f"{r_step:.2e} (gate {REL_GATE})", flush=True)
    if not r_step <= REL_GATE:
        fail(f"kernel path vs plain path rel|dU| {r_step:.2e}")

    # ---- 7. dynjac against its plain twin; one B=1 RTI step by both routes ----
    def dynjac_case(Xn, Un, pn):
        M = Xn.shape[0] * (Xn.shape[1] - 1)
        cnt = pn.cnt[:, :, :-1].transpose(1, 2).reshape(M, 4)
        Fe = (cnt[..., None] * Un[..., 18:].reshape(M, 4, 3)).reshape(M, 12)
        return (Xn[:, :-1].reshape(M, 36).contiguous(),
                Un[..., :18].reshape(M, 18).contiguous(), Fe.contiguous())

    # the JAX package's tests/test_dynjac_kernel.py bounds: values 1e-5 of
    # their scale (as dyncore), the Jacobian 3e-5 of its largest entry; the
    # structural zeros exact (the kernel stores zeros there)
    zeros = structural_zeros().to(dev)

    def dynjac_check(args):
        (pk, Jk), (pp, Jp) = dynjac(spec, *args), dynjac_plain(spec, *args)
        e_p, e_J = float((pk - pp).abs().max()), float((Jk - Jp).abs().max())
        b_p = 1e-5 * max(1.0, float(pp.abs().max()))
        b_J = 3e-5 * float(Jp.abs().max())
        z_ok = bool((Jk[:, zeros] == 0).all())
        return (pk, Jk), e_p, e_J, b_p, b_J, z_ok

    pg = params.replace(lam_ineq=lig)
    args25 = dynjac_case(Xg, Ug, pg)                            # B=1: M=25
    args_big = dynjac_case(Xe, Ue, pe)                          # M=512*25
    dj_out, e_p, e_J, b_p, b_J, z25 = dynjac_check(args25)
    _, e_p2, e_J2, b_p2, b_J2, z_big = dynjac_check(args_big)
    ok_dj = e_p <= b_p and e_J <= b_J and e_p2 <= b_p2 and e_J2 <= b_J2 and z25 and z_big
    ms_big = cuda_time_ms(lambda: dynjac(spec, *args_big), 20)
    plain_big = cuda_time_ms(lambda: dynjac_plain(spec, *args_big), 3)
    dj_device = {M: graph_time_ms(lambda a=a: dynjac(spec, *a))
                 for M, a in ((25, args25), (args_big[0].shape[0], args_big))}
    dj_attrs = dynjac_attributes()
    regs, local, blocks = dj_attrs["dynjac_kernel"]
    print(f"[dynjac] M={args_big[0].shape[0]}: prim err {e_p2:.3e} (<= {b_p2:.3e}), "
          f"J err {e_J2:.3e} (<= {b_J2:.3e}), structural zeros exact {z25 and z_big}, "
          f"{ms_big:.4f} ms vs plain {plain_big:.4f} ms; device "
          + ", ".join(f"M={M} {t:.4f} ms" for M, t in dj_device.items())
          + f"; {regs} registers, {local} B local a thread, {blocks} blocks an SM ({card})",
          flush=True)
    if local > 0:
        fail(f"dynjac uses {local} B of local memory a thread")

    b1 = b1_route_ms(solver, Xg, Ug, pg)
    print(f"[b1 step] one B=1 RTI step (linearize + riccati + merit of "
          f"{nA} alphas): dynjac route {b1['dynjac_route_ms']:.4f} ms, lingram route "
          f"{b1['lingram_route_ms']:.4f} ms ({card})", flush=True)

    # ---- 8. the closed loop on the card ----
    spec_d = go2_spec(device=dev)
    q0, v0 = standing_state(spec_d)
    mpc = LocomotionMPC(spec_d, gait_name="trot", solve_async=False,
                        phase_aligned_boot=True, device=dev)
    mpc.set_command(np.array([V_DES, 0.0, 0.0]))
    cp = device_sim.contact_params_for(spec_d, device=dev)
    st = sim_state_from_numpy(q0, v0, device=dev)
    data = PlantData()
    steps = int(round(LOOP_S / mpc.sim_dt))
    qs = np.zeros((steps, 18))
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        x = torch.cat([st.q, st.v]).cpu().numpy().astype(np.float64)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = i * mpc.sim_dt
        mpc.compute_torques_dof(data)
        tau = torch.as_tensor(mpc.torques_dof[-mpc.nu:], dtype=torch.float32, device=dev)
        st = device_sim.step(spec_d, st, tau, cp, mpc.sim_dt)
        qs[i] = x[:18]
    torch.cuda.synchronize()
    wall_loop = time.perf_counter() - t0
    loop_launches = {k.__name__: k.launches for k in kernels}
    qs = np.vstack([qs, st.q.cpu().numpy()[None]])              # + the final state
    replans = np.asarray(mpc.timings["optimize"])
    lat = replans[1:]
    z, rp = qs[:, 2], np.degrees(np.abs(qs[:, 4:6]))
    vx = (qs[-1, 0] - q0[0]) / LOOP_S
    finite = bool(np.isfinite(qs).all())
    print(f"[closed loop] Go2 trot, {LOOP_S} s at 1 kHz on the device plant, "
          f"v_des {V_DES} m/s: {len(replans)} replans, boot offset "
          f"{mpc.boot_offsets}, mean vx {vx:.4f} m/s, base z {z.min():.4f}..{z.max():.4f} m, "
          f"max |roll|,|pitch| {rp.max():.2f} deg, finite {finite}, diverged "
          f"{mpc.diverged}, launches {loop_launches}, wall {wall_loop:.2f} s", flush=True)
    print(f"[replan latency] first {replans[0]:.3f} ms (boot + 15 iterations), "
          f"RTI median {np.median(lat):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms, "
          f"max {lat.max():.3f} ms against the {BUDGET_MS:.0f} ms budget ({card})",
          flush=True)
    mpc.close()
    if not finite or mpc.diverged:
        fail("the closed loop diverged or went non-finite")
    if not (z.min() > 0.15 and z.max() < 0.45 and rp.max() < 25.0):
        fail(f"the robot fell: z {z.min():.3f}..{z.max():.3f}, tilt {rp.max():.1f} deg")
    if not vx > 0.2:
        fail(f"mean forward speed {vx:.3f} m/s <= 0.2")
    if loop_launches["dynjac"] <= 0 or loop_launches["lingram"] <= 0:
        fail(f"the closed loop did not launch dynjac and lingram: {loop_launches}")

    # dynjac's entry: at the controller's shape, launches from the loop
    record("dynjac", "iterative_learning_nmpc_tpu_torch/csrc/dynjac.cu",
           "iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:573", max(e_p, e_J), ok_dj,
           f"M=25: prim <= {b_p:.3e}, J <= 3e-5 * max|J| = {b_J:.3e} (J err {e_J:.3e}); "
           f"M={args_big[0].shape[0]}: prim {e_p2:.3e} <= {b_p2:.3e}, J {e_J2:.3e} <= {b_J2:.3e}; "
           "structural zeros exact",
           cuda_time_ms(lambda: dynjac(spec, *args25), 50),
           cuda_time_ms(lambda: dynjac_plain(spec, *args25), 5),
           dynjac_plain, (spec, *args25), dj_out, n_launch=loop_launches["dynjac"],
           extra=dict(kernel_attributes=dj_attrs, device_ms_by_M=dj_device,
                      ms_by_M={args_big[0].shape[0]: ms_big}))

    # ---- 9. the controller against the JAX-on-CPU golden ----
    gold = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_closed_loop_golden.npz"))
    mpc = LocomotionMPC(spec_d, gait_name="trot", solve_async=False,
                        phase_aligned_boot=True, device=dev)
    mpc.set_command(gold["v_des"])
    q_plan, _, _, _, tau_ff = mpc.optimize(gold["q0"], gold["v0"])
    mpc.close()
    off = mpc.boot_offsets[0]
    du = rel(mpc._U_prev[0].cpu(), torch.as_tensor(gold["U"]))
    dq = rel(torch.as_tensor(q_plan), torch.as_tensor(gold["q_plan"]))
    dtau = rel(torch.as_tensor(tau_ff), torch.as_tensor(gold["tau_ff"]))
    print(f"[controller vs JAX] boot offset {off} (golden {int(gold['boot_offset'])}), "
          f"first plan rel|dU| {du:.2e} (gate {REL_GATE}), q_plan {dq:.2e}, "
          f"tau_ff {dtau:.2e}", flush=True)
    if off != int(gold["boot_offset"]):
        fail(f"boot offset {off} != golden {int(gold['boot_offset'])}")
    if not du <= REL_GATE:
        fail(f"first plan rel|dU| {du:.2e} > {REL_GATE}")

    # ---- 10-13. the learned-policy serving path ----
    pp_args, fp32_times, datagen_rows = policy_phases(dev, card, spec_d, q0, kernels,
                                                      launches, record)

    # ---- 14-16. the Riccati routes ----
    n100 = riccati_route_phases(dev, card, solver, conv, params, golden, kernels, launches,
                                record)
    next(r for r in results if r["name"] == "lingram").update(n100)
    # ---- 17-19. the bf16 policy, the card's ceilings, the node solve ----
    policy_bf16_phase(dev, card, pp_args, fp32_times, kernels, record)
    tf, bw = ceiling_phase(dev, card, kernels, record)
    node_solve_phase(dev, card, kernels, record)
    # ---- 20-21. the training side ----
    training_phases(dev, card, spec_d, datagen_rows, kernels)
    for r in results:
        r["bound_measured_ms"] = bound_of(*counts[r["name"]], peak_flops=tf * 1e12,
                                          peak_bytes=bw * 1e9)[0]
    print("[measured bounds] over the measured fp32 FMA and HBM ceilings (bf16 tensor-core "
          "work at the nominal 989 TFLOP/s): " + ", ".join(
              f"{r['name']} {r['bound_measured_ms']:.6f} ms" for r in results), flush=True)

    print(f"[wall] chip_smoke.py {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
