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
     seeded untrained 3 x 512 BatchNorm policy, 256 envs, 0.2 s (5
     intervals), delay 20, MPC latched >= 60, one goal (0.3, 0, 0), 2
     iterations of (collect -> train: 3 epochs, batch 256, lr 1e-3), the
     counters set to 0 before each collect and read after it (kernels 1-3
     launched, kernel 8 once a control step, the dense route never): the
     JAX package's slow-test gates (two data steps, expert ratio > 0.3 at
     the first, the aggregate growing, the final payload new, loading and
     served on route "kernel"); each collect's and training's wall,
 22. Solo12 (tests/data/solo12_trot_golden.npz): kernels 1, 2, 3 against
     their twins at one B=512 warm RTI step of Solo12's converged standing
     problem (noisy starts), kernel 7 at M=25; the controller's cold boot
     (the offset, or its mirror-image tie) and first plan against the
     golden; then LocomotionMPC on the device plant: the trot (0.2 m/s, 2 s,
     sync) and the push (0.25 m/s, 3 s, async at 0.02 s, 8 N / 4 N over
     1.2-1.4 s), held to the JAX controller's run on the JAX device plant
     (solo12_gates),
 23. contact-restricted MPC, Go2 trot: kernels 1-3 against their twins on
     a B=512 batch of the Raibert controller's restricted parameters from
     noisy starts (half with a 3 cm patch radius), kernel 2 per row group;
     LocomotionMPC(contact_planner="raibert")'s first plan against the
     golden (footsteps and base references to 1e-6); one B=1 RTI step by the
     dynjac and the lingram routes against the float64 step; a 2 s closed
     loop at 0.3 m/s with phase 8's gates; contact_planner="custom"'s first
     plan from a fixed footstep table,
 24. AcyclicMPC: 6 cm patches (the plan against the golden, the stance feet
     in their patches) and the standing hop (flight forces exactly 0, the
     apex, the takeoff velocity; 2.5 s on the device plant: it takes off
     and lands upright),
 25. the policy warm starts with the shipped policy at B=1 and B=256:
     kernel 8 exactly N=25 times a call, the first two nodes against the
     golden within the JAX package's own spread, the phase pick exact on
     the golden's node states, the warm-started solve finite, each call
     timed beside cold_start.
     Phases 22-25 set the counters to 0 before and read them after; their
     closed loops step the plant as one CUDA graph (device_sim.graphed).
 26. randomized datagen and scale-out: B=256 x 0.8 s of expert datagen,
     each plant with its payload and terrain (randomize_payload,
     randomize_terrain), 50-70 N pushes on the second half
     (sample_force_windows), the draws equal to
     tests/data/go2_trot_randomized_datagen_golden.npz's; the 256 payload
     plants alone (no controller, pushes held on) within 1e-4 (q) / 1e-3
     (v) of the JAX plant's states stored there; the datagen's valid share
     within RAND_VALID_MARGIN of the JAX run on the draws, kernels 1-3
     launched, the payload plant step as a CUDA graph bit-equal to the
     eager step, rows/s beside phase 12's; graft_entry.dryrun_multichip(1)
     in a NCCL process group of one rank (the sharded solve, the dp train
     step and the sharded SafeDAgger data step within the JAX dryrun's
     gates; its counters read alone, kernels 1-3 launched); the datagen and
     DAgger CLIs (examples/) as subprocesses, their npz read back by
     Database.load, their launches parsed from their output.
 27. the host controllers on the card, against
     tests/data/go2_host_loop_golden.npz (the JAX package on the CPU,
     scripts/make_torch_host_loop_golden.py), each part with the counters
     set to 0 before it and read after it: (a) PolicyController (the
     shipped policy, served at B=1: kernel 8 once a control step) at 0.15
     m/s for 1 s on the device plant, coupled through phase 28's simulator
     stand-in (DevicePlantSimulator: the spec, the foot geoms and their
     positions from the plant state), upright, every 100th action held to the kernel's CPU twin
     on the same input within phase 10's bound, ms a control step and
     inference_ms; (b) CombinedController (that policy and LocomotionMPC,
     delay 100 steps, the MPC latched >= 200) for 1 s with the golden's
     push, which trips the monitor in the JAX run: the expert takes over,
     no fall, kernels 1, 2, 3, 7 and 8 launched, the switch times beside
     the JAX run's; (c) Go2's push recovery (40 N / 20 N over 0.7-0.9 s,
     1.6 s) and turning (0.2 m/s, w_yaw 0.4, 2 s) with LocomotionMPC on the
     device plant: the JAX package's tests/test_closed_loop.py gates (the
     JAX controller on the JAX device plant passes them), the turn's final
     yaw within TURN_YAW_TOL of the JAX run's; (d) examples/run_mpc.py
     --mode traj_opt and --mode open_loop --sim_time 0.5 as subprocesses,
     their launches parsed from their output ("27 cli"),
 28. the host-side learning pipeline on the device plant, which a
     DevicePlantSimulator (the Simulator surface: reset, step, run, the
     fall test, data.qpos/qvel/ctrl/xfrc_applied/geom_xpos) puts in MuJoCo's
     place as the Simulator that learning.plant_batch and learning.rollouts
     build, each part with the counters set to 0 before it and read after
     it: (a) BatchedPlantCollector expert-only at E=16 for 0.2 s (joint
     noise 0.02, seed 3): no fall, every row expert, 16 x 200 rows, kernels
     1, 2, 3 launched and kernel 7 not, the first batched plan within
     REL_GATE of the same call through the plain twins on the card; env-sim-s
     per s, ms a control step, replan ms at B=16; (b) the same combined
     (the shipped policy, delay 20, latch 60, phase 27's combined push on
     the odd envs): kernel 8 once a control step, each env's labels equal a
     SwitchLatch replay of its monitor log, the expert in a pushed env; (c)
     DataCollection.run (Go2 trot at 0.3 m/s, 0.5 s nominal, two replanning
     points, one 0.3 s pushed restart each): the npz snapshot's rows the kept
     rollouts', kernels 1, 3 and 7 launched; (d) SafeDaggerPipeline.run (goal
     0.15 m/s, one iteration, 0.3 s, onto (c)'s snapshot, 3 epochs at batch
     64): the aggregate (c)'s rows plus the expert rows, BC on the card, the
     new policy served through kernel 8; (e) examples/train_bc.py on (c)'s
     snapshot as a subprocess ("28 cli"): its config_smoke.yaml, written
     without PyYAML, read back by the port's load_config to the same
     TrainConfig.

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
import re
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
# (DAGGER_SIM_S was 0.4 s until phase 27 joined: cut to keep the script
# near 750 s on the slower hosts, 89.2 s of phase 21's wall at 0.4 s)
DAGGER_SIM_S, DAGGER_ITERS, DAGGER_EPOCHS, DAGGER_BATCH, DAGGER_LR = 0.2, 2, 3, 256, 1e-3
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
# phases 22-24: Solo12's trot (the JAX package's tests/test_solo12_closed_loop.py:
# 0.2 m/s for 2 s, sync; 0.25 m/s for 3 s, async, pushed 8 N / 4 N over
# 1.2-1.4 s), the standing hop's 2.5 s. On the device plant the JAX
# controller lets Solo12 sink below half its nominal height at these times
# (s), with this max |roll| (rad) before it
# (scripts/make_torch_controller_modes_golden.py --closed-loops, JAX on the CPU)
SOLO12_V, SOLO12_S, SOLO12_PUSH_V, SOLO12_PUSH_S = 0.2, 2.0, 0.25, 3.0
SOLO12_PUSH = ((1.2, 1.4, (8.0, 4.0, 0.0)),)
SOLO12_REF = {"trot": (SOLO12_V, 0.994, 0.1729), "push": (SOLO12_PUSH_V, 0.796, 0.1947)}
FALL_MARGIN_S, HOP_S = 0.2, 2.5
# phase 26: the randomized datagen's valid share within RAND_VALID_MARGIN of
# the JAX package's on the same draws (0.9041, 79 of 256 envs fall;
# scripts/make_torch_randomized_datagen_golden.py, JAX on the CPU): eight
# envs' worth of the share, MAX_FALLS' margin, since when an env falls is
# not reproducible across fp32 libraries. Measured: the card -0.0012 (77
# falls; H100 80GB HBM3, 700 W); the port on the CPU on every 4th env
# +0.0023 (22 falls each, 13 of 64 envs falling at other times); the card
# without the payloads +0.0646, without the terrain +0.0357
# (scripts/randomized_datagen_gate_torch.py). The valid share is an
# aggregate; the payload plants are held state by state to the JAX plant
# (the golden's plant_q / plant_v) within tests/test_torch_plant.py's
# bounds. The port on the CPU is 1.2e-6 (q) / 1.1e-4 (v) off it; a push
# divided by every env's summed mass, a payload on the neighbour env or no
# payload is 3.6e-4..1.3e-3 (q) and 4.3e-2..1.3 (v) off it by step 10. The
# CLIs' batch and seconds
RAND_VALID_MARGIN = 8 / 256
PLANT_Q_TOL, PLANT_V_TOL = 1e-4, 1e-3
CLI_B, CLI_DAGGER_B, CLI_S, CLI_TIMEOUT_S = 16, 8, 0.08, 300
RATES = {}                 # rows/s by path, for the phases that compare them
# phase 27: the host controllers on the card. PolicyController alone at
# HOST_V for HOST_S (its every HOST_CHECK-th action held to the CPU twin);
# CombinedController (delay and latch of the golden's runs) for HOST_S with
# the golden's push; Go2's push recovery and turning (the JAX package's
# tests/test_closed_loop.py:33-59 scenarios) on the device plant, held to
# the JAX controller's runs on the JAX device plant
# (tests/data/go2_host_loop_golden.npz, scripts/make_torch_host_loop_golden.py);
# the final yaw of the turn within TURN_YAW_TOL of the JAX run's (1.0519
# rad): three times the widest reading of the port, 1.0695 in two runs on an
# H100 80GB HBM3 at 700 W (equal to every digit) and 1.0839 on the CPU
HOST_V, HOST_S, HOST_CHECK = 0.15, 1.0, 100
PUSH_S, PUSH = 1.6, ((0.7, 0.9, (40.0, 20.0, 0.0)),)
TURN_S, TURN_V, TURN_W = 2.0, 0.2, 0.4
TURN_YAW_TOL = 0.1
OPEN_LOOP_S = 0.5
# phase 28: the host-side learning pipeline on the device plant. The batched
# collector at the collect_plant_batch CLI's default E and goals, 0.2 s,
# joint noise 0.02, seed 3 (the JAX tests/test_plant_batch.py settings);
# combined (the shipped policy, DELAY_STEPS / MPC_MIN_STEPS) for PB_COMB_S,
# phase 27's combined push on the odd envs; DataCollection (Go2 trot, one
# trot period nominal, two replanning points, one pushed restart each); the
# SafeDAgger pipeline (one goal, one iteration) onto its rows; train_bc
PB_E, PB_GOALS, PB_S, PB_NOISE, PB_SEED, PB_COMB_S = 16, (0.3, 0.15, 0.0, -0.15), 0.2, 0.02, 3, 0.3
DC_V, DC_NOMINAL_S, DC_GRID, DC_PERTURBED_S = 0.3, 0.5, 250, 0.3
SD_V, SD_S, SD_BATCH, SD_EPOCHS, TRAIN_EPOCHS = 0.15, 0.3, 64, 3, 2


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
    """What a controller's compute_torques_dof reads: time, qpos, qvel in
    MuJoCo layout (and, in a DevicePlantSimulator, the rest of MuJoCo's
    data that the pipeline reads)."""
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
    RATES["datagen"] = B_ENV * T_dg / wall_dg

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



# ---------------------------------------------------------------------------
# phases 22-25: the controller's other modes, the second robot, the policy
# warm starts (tests/data/*_golden.npz from
# scripts/make_torch_controller_modes_golden.py)
def zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def load_golden(name):
    import numpy as np

    return np.load(os.path.join(ROOT, "tests", "data", f"{name}_golden.npz"))


class PlantGraph:
    """One B=1 device-plant step (``sim/device_sim``) and the feet's world
    points after it as a CUDA graph: the plant step of every closed loop on
    the device plant (``plant_loop``) and of phase 28's simulators, which
    share one. A step copies the chart state, the joint torques and the
    trunk force in (one copy), replays the graph and reads the state and the
    feet back (one copy). ``eager_gap`` holds the replay to the eager step:
    the first version of phase 28 replayed a graph whose contact parameters
    had been freed (``device_sim.graphed`` did not yet hold the function it
    captured), and 15 of 16 envs fell. ``calls`` and ``busy_s`` count the
    steps and the wall inside them (the copies and the replay: the copy back
    waits for the replay), for phase 28's split of a control step."""

    calls, busy_s = 0, 0.0

    def __init__(self, spec, dev, dt=1e-3):
        import torch

        from iterative_learning_nmpc_tpu_torch.models.dynamics import settled_state
        from iterative_learning_nmpc_tpu_torch.sim import device_sim

        self.spec, self.dt = spec, dt
        self.cp = device_sim.contact_params_for(spec, device=dev)
        self.dev, self.t = dev, torch.zeros(1, device=dev)
        x0 = torch.as_tensor(settled_state(spec.to("cpu")), device=dev)[None]
        self.run = device_sim.graphed(self.eager_step, x0[:, :18].contiguous(),
                                      x0[:, 18:].contiguous(), self.t,
                                      torch.zeros(1, 12, device=dev), torch.zeros(1, 3, device=dev))

    def eager_step(self, q, v, t, tau, f):
        from iterative_learning_nmpc_tpu_torch.models.dynamics import foot_positions
        from iterative_learning_nmpc_tpu_torch.sim import device_sim

        q, v, t = device_sim.step(self.spec, device_sim.SimState(q, v, t), tau, self.cp, self.dt,
                                  f_ext=f)
        return q, v, t, foot_positions(self.spec, q).reshape(1, 12)

    def __call__(self, x, run=None):
        """x (51,) float32: q, v (chart), tau (12), trunk force (3) -> the
        chart state after the step and the feet's world points (48,)."""
        import torch

        t0 = time.perf_counter()
        d = torch.as_tensor(x).to(self.dev)
        q, v, _, feet = (run or self.run)(d[None, :18], d[None, 18:36], self.t, d[None, 36:48],
                                          d[None, 48:])
        y = torch.cat([q, v, feet], -1)[0].cpu().numpy()
        self.calls, self.busy_s = self.calls + 1, self.busy_s + time.perf_counter() - t0
        return y

    def eager_gap(self, n=5, seed=0):
        """max |graph step - eager step| over n random near-standing inputs."""
        import numpy as np

        from iterative_learning_nmpc_tpu_torch.models.dynamics import settled_state

        rng, x0 = np.random.default_rng(seed), settled_state(self.spec.to("cpu"))
        gap = 0.0
        for _ in range(n):
            x = np.concatenate([x0 + rng.normal(0, 0.01, 36), rng.normal(0, 5, 12),
                                rng.normal(0, 10, 3)]).astype(np.float32)
            gap = max(gap, float(np.abs(self(x) - self(x, self.eager_step)).max()))
        return gap


class DevicePlantSimulator:
    """The ``sim/mujoco_sim.Simulator`` surface the learning pipeline uses,
    on the device plant: ``reset``, ``set_state``, ``step`` (one replay of
    a ``PlantGraph`` with ``data.ctrl`` and the trunk's force in
    ``data.xfrc_applied``), ``run`` (``Simulator.run``'s own loop),
    ``_bad_collision`` (the datagen fall test, ``learning.safety.upright``'s
    bounds), ``feet_in_contact``; ``data.{qpos, qvel, ctrl, xfrc_applied,
    geom_xpos, time}`` in MuJoCo layout, ``trunk_body`` and ``foot_geoms``
    (the feet's world points by the dynamics' float32 FK: in the graph
    after a step, on the host after ``set_state``). ``plant_loop`` couples
    every closed loop on the device plant through one. No package code
    knows of it: phase 28 installs it as the ``Simulator``
    that ``learning.rollouts`` and ``learning.plant_batch`` build."""

    foot_geoms = {0: "FL", 1: "FR", 2: "RL", 3: "RR"}
    trunk_body = 0
    _mj = None

    def __init__(self, spec, graph, sim_dt=1e-3):
        import numpy as np

        from iterative_learning_nmpc_tpu_torch.sim.mujoco_sim import Simulator

        self.spec, self._host, self.graph, self.sim_dt = spec, spec.to("cpu"), graph, sim_dt
        self._foot_r = float(self._host.foot_radius)
        self.run = Simulator.run.__get__(self)
        self.data = PlantData()
        self.data.ctrl, self.data.xfrc_applied = np.zeros(12), np.zeros((1, 6))
        self.reset()

    def reset(self, q_mj=None, v_mj=None):
        import numpy as np

        from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
        from iterative_learning_nmpc_tpu_torch.models.dynamics import settled_state

        self.data.time = 0.0
        self.data.ctrl[:] = 0.0
        self.data.xfrc_applied[:] = 0.0
        if q_mj is None:
            x = settled_state(self._host).astype(np.float64)
            q_mj, v0 = tnp.convert_to_mujoco(x[:18], x[18:])
            v_mj = v0 if v_mj is None else v_mj
        self.set_state(q_mj, np.zeros(18) if v_mj is None else v_mj)

    def set_state(self, q_mj, v_mj):
        import numpy as np

        self.data.qpos = np.array(q_mj, np.float64)
        self.data.qvel = np.array(v_mj, np.float64)
        self._forward()

    def _forward(self, feet=None):
        import numpy as np
        import torch

        from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
        from iterative_learning_nmpc_tpu_torch.models.dynamics import foot_positions

        self._q, self._v = tnp.convert_from_mujoco(self.data.qpos, self.data.qvel)
        if feet is None:
            feet = foot_positions(self._host, torch.as_tensor(self._q, dtype=torch.float32))
            feet = feet.numpy()
        self.data.geom_xpos = np.asarray(feet, np.float64).reshape(4, 3)

    def step(self):
        import numpy as np

        from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp

        x = np.concatenate([self._q, self._v, self.data.ctrl,
                            self.data.xfrc_applied[self.trunk_body, :3]]).astype(np.float32)
        y = self.graph(x).astype(np.float64)
        self.data.qpos, self.data.qvel = tnp.convert_to_mujoco(y[:18], y[18:36])
        self.data.time += self.sim_dt
        self._forward(y[36:])

    def _bad_collision(self) -> bool:
        from iterative_learning_nmpc_tpu_torch.learning.safety import (
            FALL_HEIGHT_BOUNDS, FALL_MAX_TILT_RAD)

        q = self._q
        return not (FALL_HEIGHT_BOUNDS[0] < q[2] < FALL_HEIGHT_BOUNDS[1]
                    and abs(q[4]) < FALL_MAX_TILT_RAD and abs(q[5]) < FALL_MAX_TILT_RAD)

    def feet_in_contact(self):
        return [leg for i, leg in self.foot_geoms.items()
                if self.data.geom_xpos[i, 2] <= self._foot_r + 2e-3]


def plant_loop(dev, spec, mpc, q0, seconds, pushes=(), sim=None):
    """``mpc`` (any controller with ``compute_torques_dof`` and
    ``torques_dof``) on the device plant for ``seconds`` at 1 kHz from (q0,
    0), through ``compute_torques_dof`` as phase 8 couples them: the
    controller reads ``sim.data`` (a ``DevicePlantSimulator``, the one a
    policy controller was built on, or a new one) and the plant steps by
    ``sim.step()``, one replay of its ``PlantGraph``. ``pushes`` are (start,
    end, (3,) world force on the base) windows, as the MuJoCo simulator's
    force schedule. Returns the chart states (steps + 1, 18) and the wall."""
    import numpy as np

    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp

    dt, nu = getattr(mpc, "sim_dt", 1e-3), spec.nu
    if sim is None:
        sim = DevicePlantSimulator(spec, PlantGraph(spec, dev, dt), sim_dt=dt)
    sim.reset(*tnp.convert_to_mujoco(np.asarray(q0, np.float64), np.zeros(18)))
    n = int(round(seconds / dt))
    qs = np.zeros((n + 1, 18))
    t0 = time.perf_counter()
    for i in range(n):
        qs[i] = sim._q
        sim.data.time = i * dt
        mpc.compute_torques_dof(sim.data)
        push = np.zeros(3)
        for a, b, force in pushes:
            if a <= sim.data.time < b:
                push += force
        sim.data.ctrl[:] = mpc.torques_dof[-nu:]
        sim.data.xfrc_applied[sim.trunk_body, :3] = push
        sim.step()
    qs[n] = sim._q
    return qs, time.perf_counter() - t0


def fall_time(qs, nom_height, dt=1e-3):
    """The first time the base is below half the nominal height or tilted
    beyond 25 degrees (the closed loops' fall rule), or None."""
    import numpy as np

    bad = (qs[:, 2] < 0.5 * nom_height) | (np.degrees(np.abs(qs[:, 4:6])).max(1) > 25.0)
    return float(np.argmax(bad) * dt) if bad.any() else None


def latency(mpc, upto=None) -> str:
    """The replans' wall: all of them, and with ``upto`` (s) also those
    submitted before it (one every replanning interval)."""
    import numpy as np

    r = np.asarray(mpc.timings["optimize"])
    text = (f"{len(r)} replans, first {r[0]:.3f} ms, RTI median {np.median(r[1:]):.3f} ms, "
            f"p95 {np.percentile(r[1:], 95):.3f} ms")
    n = None if upto is None else int(upto * mpc.replanning_freq)
    if n is not None and n > 2:
        text += (f"; before {upto} s: RTI median {np.median(r[1:n]):.3f} ms, p95 "
                 f"{np.percentile(r[1:n], 95):.3f} ms")
    return text


def twin_checks(solver, X, U, p):
    """Kernels 2, 3 and 1 against their plain twins at one RTI step's inputs
    (X, U, p) of B problems, within the bounds of phases 5 and 14: lingram
    by ``gram_gate`` (every row group on and each alone), riccati_rollout by
    rel |d(dU, dX)| <= REL_GATE or by the float64 rule of the sweep kernels
    it shares its stage with, dyncore on the line-search candidates by
    1e-5 of the output scale. Returns {name: (ok, text)}."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore, dyncore_plain
    from iterative_learning_nmpc_tpu_torch.ops.lingram import (
        _double, gate_failures, gate_summary, gram_gate, lingram)
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        riccati_rollout, riccati_rollout_plain)
    from iterative_learning_nmpc_tpu_torch.solver.linearize import dyncore_inputs

    spec, w, N = solver.spec, solver.weights, solver.N
    inc = solver.opt.torque_limit_in_qp
    gate = gram_gate(lingram, spec, w, X, U, p, inc)
    bad = gate_failures(gate)
    out = {"lingram": (not bad, gate_summary(gate) + "; outside: " + (", ".join(bad) or "none"))}
    ric = (spec, w, solver.dt_nodes, float(solver.opt.lm_reg), float(solver.cost.reg_eps_e),
           *lingram(spec, w, X, U, p, inc), solver._defects(X, U, p), p.x0 - X[:, 0],
           X[:, -1], p.peak[:, :, -1], p.base_ref_e, p.joint_ref, p.step_height)
    (dX, dU), (dXp, dUp) = riccati_rollout(*ric), riccati_rollout_plain(*ric)
    r = max(rel(dU, dUp), rel(dX, dXp))
    # phase 5's gate, or the sweep kernels' (phase 14) where the fp32 twin
    # itself is further than REL_GATE from the float64 step on the same
    # blocks: a step from noisy starts (1-4e-2 at Go2's constants, 3.5e-3 at
    # Solo12's, 64 problems on the CPU)
    ref = riccati_rollout_plain(_double(spec), _double(w), *(
        t.double() if isinstance(t, torch.Tensor) else t for t in ric[2:]))
    r_k, r_p = (max(rel(a.double(), b) for a, b in zip(out_, ref))
                for out_ in ((dX, dU), (dXp, dUp)))
    ok = r <= REL_GATE or r_k <= 2.0 * r_p + 0.1 * REL_GATE
    out["riccati_rollout"] = (ok, f"rel {r:.2e} (<= {REL_GATE}, or to the float64 step "
                                  f"{r_k:.2e} <= 2 x the fp32 twin's {r_p:.2e} + "
                                  f"{0.1 * REL_GATE:.0e})")
    alphas = torch.tensor(solver.opt.ls_alphas_steady, device=X.device)[:, None, None, None]
    Xc = (X[None] + alphas * dX[None]).reshape(-1, N + 1, 36)
    Uc = (U[None] + alphas * dU[None]).reshape(-1, N, 30)
    pc = p.map(lambda t: t.repeat((len(alphas),) + (1,) * (t.dim() - 1)))
    rows = [t.contiguous() for t in dyncore_inputs(Xc, Uc, pc)]
    ref = dyncore_plain(spec, *rows)
    e, b = float((dyncore(spec, *rows) - ref).abs().max()), 1e-5 * max(1.0, float(ref.abs().max()))
    out["dyncore"] = (e <= b, f"M={rows[0].shape[0]}: {e:.2e} (<= {b:.2e})")
    return out


def dynjac_check(spec, X, U, p):
    """Kernel 7 against its twin at one problem's N nodes (the controller's
    shape), within phase 7's bounds, its structural zeros exact."""
    from iterative_learning_nmpc_tpu_torch.ops.dynjac import (
        dynjac, dynjac_plain, structural_zeros)

    M = X.shape[0] * (X.shape[1] - 1)
    cnt = p.cnt[:, :, :-1].transpose(1, 2).reshape(M, 4, 1)
    args = (X[:, :-1].reshape(M, 36).contiguous(), U[..., :18].reshape(M, 18).contiguous(),
            (cnt * U[..., 18:].reshape(M, 4, 3)).reshape(M, 12).contiguous())
    (pk, Jk), (pp, Jp) = dynjac(spec, *args), dynjac_plain(spec, *args)
    e_p, e_J = float((pk - pp).abs().max()), float((Jk - Jp).abs().max())
    b_p, b_J = 1e-5 * max(1.0, float(pp.abs().max())), 3e-5 * float(Jp.abs().max())
    zeros = bool((Jk[:, structural_zeros().to(X.device)] == 0).all())
    return (e_p <= b_p and e_J <= b_J and zeros,
            f"M={M}: prim {e_p:.2e} (<= {b_p:.2e}), J {e_J:.2e} (<= {b_J:.2e}), "
            f"structural zeros exact {zeros}")


def report_checks(tag, checks) -> None:
    for name, (ok, text) in checks.items():
        print(f"[{tag}] {name} against its twin: {text}", flush=True)
        if not ok:
            fail(f"{tag}: {name} outside its bound of its twin: {text}")


def b1_route_check(solver, X, U, p):
    """One B=1 RTI step's (dX, dU) by the dynjac route (kernel 7 in
    ``lingram_structured``) and by the lingram route (kernel 2), each held
    to the float64 step of the plain twins: no further from it than twice
    the fp32 plain step is (phase 14's rule for the sweep kernels). Near a
    converged plan the step is a small difference of large Gram blocks, and
    fp32 rounding of the blocks (5e-8 of their scale) moves it by ~1e-2 in
    either route. Returns (ok, text)."""
    from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac
    from iterative_learning_nmpc_tpu_torch.ops.lingram import _double, lingram, lingram_plain
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        riccati_rollout, riccati_rollout_plain)
    from iterative_learning_nmpc_tpu_torch.solver.linearize import lingram_structured

    inc = solver.opt.torque_limit_in_qp

    def step(ric, gram, spec, w, X, U, p):
        return ric(spec, w, solver.dt_nodes, float(solver.opt.lm_reg),
                   float(solver.cost.reg_eps_e), *gram(spec, w, X, U, p),
                   solver._defects(X, U, p), p.x0 - X[:, 0], X[:, -1], p.peak[:, :, -1],
                   p.base_ref_e, p.joint_ref, p.step_height)

    args = (solver.spec, solver.weights, X, U, p)
    routes = {
        "dynjac": step(riccati_rollout, lambda *a: lingram_structured(*a, inc, dynjac_fn=dynjac),
                       *args),
        "lingram": step(riccati_rollout, lambda *a: lingram(*a, inc), *args),
        "plain": step(riccati_rollout_plain, lambda *a: lingram_plain(*a, inc), *args)}
    ref = step(riccati_rollout_plain, lambda *a: lingram_plain(*a, inc),
               _double(solver.spec), _double(solver.weights), X.double(), U.double(), _double(p))
    err = {k: max(rel(a.double(), b) for a, b in zip(v, ref)) for k, v in routes.items()}
    between = max(rel(a, b) for a, b in zip(routes["dynjac"], routes["lingram"]))
    ok = max(err["dynjac"], err["lingram"]) <= 2.0 * err["plain"]
    return ok, (f"rel to the float64 step: dynjac route {err['dynjac']:.2e}, lingram route "
                f"{err['lingram']:.2e}, fp32 plain {err['plain']:.2e} (each route <= 2x plain); "
                f"between the routes {between:.2e}")


def stack_params(ps):
    import dataclasses

    import torch

    from iterative_learning_nmpc_tpu_torch.ocp.problem import OCPParams

    return OCPParams(**{f.name: torch.cat([getattr(p, f.name) for p in ps])
                        for f in dataclasses.fields(OCPParams)})


def solo12_phase(dev, card, kernels) -> dict:
    """Phase 22: Solo12 (about a sixth of Go2's mass) on the card."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.mpc import controller as controller_module
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec

    t_phase = time.perf_counter()
    zero(kernels)
    # kernels 1, 2, 3 at Solo12's constants: one B=512 warm RTI step from
    # the converged standing problem, the starts with joint noise
    solver, X, U, params = F.flagship(device=dev, robot="solo12")
    conv = solver.solve(X, U, params, 15)
    q0 = params.x0[0, :18].cpu().numpy()
    x0b = np.concatenate([noisy_starts(q0, BATCH, np.random.default_rng(SEED)),
                          np.zeros((BATCH, 18), np.float32)], 1)
    pb = params.map(lambda t: t.expand((BATCH,) + t.shape[1:]).contiguous())
    pb = pb.replace(x0=torch.as_tensor(x0b, dtype=torch.float32, device=dev),
                    lam_ineq=conv.lam_ineq.expand(BATCH, -1, -1).contiguous())
    Xb = conv.X.expand(BATCH, -1, -1).clone()
    Xb[:, 0] = pb.x0
    Ub = conv.U.expand(BATCH, -1, -1).contiguous()
    step = solver.solve(Xb, Ub, pb, 1)
    finite = bool(torch.isfinite(step.U).all() and torch.isfinite(step.stats.cost).all())
    print(f"[solo12] B={BATCH} warm RTI step from the converged standing problem (cost "
          f"{float(conv.stats.cost[0]):.4f}), joint noise {NOISE}: mean cost "
          f"{float(step.stats.cost.mean()):.4f}, finite {finite}", flush=True)
    if not finite:
        fail("solo12: non-finite B=512 RTI step")
    checks = twin_checks(solver, Xb, Ub, pb)
    checks["dynjac"] = dynjac_check(solver.spec, conv.X, conv.U, params)
    report_checks("solo12", checks)

    # the controller's cold boot and first plan against the JAX golden
    spec = solo12_spec(device=dev)
    g = load_golden("solo12_trot")
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, device=dev)
    seen = {}
    boot = controller_module.merit_phase_boot
    controller_module.merit_phase_boot = lambda *a, **k: seen.setdefault("boot", boot(*a, **k))
    try:
        mpc.set_command(g["v_des"])
        q_plan, _, _, _, tau_ff = mpc.optimize(g["q0"], g["v0"])
    finally:
        controller_module.merit_phase_boot = boot
    mpc.close()
    costs, off, gold = seen["boot"][2].cpu().numpy(), mpc.boot_offsets[0], int(g["boot_offset"])
    # Solo12 is mirror-symmetric: offsets half a cycle apart are mirror
    # images and tie up to rounding (tests/test_torch_solo12.py)
    C = len(costs)
    tie = off == (gold + C // 2) % C and abs(costs[off] - costs[gold]) <= 1e-5 * costs[gold]
    if off == gold:
        du = rel(mpc._U_prev[0].cpu(), torch.as_tensor(g["U"]))
    else:
        # the tie's other offset: the golden's plan at the golden's offset
        mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False,
                            phase_aligned_boot=False, device=dev)
        mpc.set_command(g["v_des"])
        mpc.current_opt_node = gold
        mpc.optimize(g["q0"], g["v0"])
        mpc.close()
        du = rel(mpc._U_prev[0].cpu(), torch.as_tensor(g["U"]))
    print(f"[solo12 controller vs JAX] boot offset {off} (golden {gold}; probe costs "
          f"{costs.min():.4f}..{costs.max():.4f}, golden {g['probe_costs'].min():.4f}.."
          f"{g['probe_costs'].max():.4f}), first plan rel|dU| {du:.2e} (gate {REL_GATE})",
          flush=True)
    if not (off == gold or tie):
        fail(f"solo12 boot offset {off} != golden {gold}")
    if not du <= REL_GATE:
        fail(f"solo12 first plan rel|dU| {du:.2e} > {REL_GATE}")

    # the trot, then the push, on the device plant
    loops = {}
    for name, v_des, seconds, pushes, asynchronous in (
            ("trot", SOLO12_V, SOLO12_S, (), False),
            ("push", SOLO12_PUSH_V, SOLO12_PUSH_S, SOLO12_PUSH, True)):
        mpc = LocomotionMPC(spec, gait_name="trot", solve_async=asynchronous,
                            async_sim_latency=0.02, device=dev)
        mpc.set_command(np.array([v_des, 0.0, 0.0]))
        qs, wall = plant_loop(dev, spec, mpc, g["q0"], seconds, pushes)
        mpc.close()
        qf = np.vstack(mpc.q_full)
        half = len(qf) // 2
        t_fall = fall_time(qs, mpc.config_gait.nom_height)
        loops[name] = dict(qs=qs, nom=mpc.config_gait.nom_height)
        print(f"[solo12 {name}] {seconds} s at {v_des} m/s on the device plant"
              + (f", {SOLO12_PUSH[0][2]} N over {SOLO12_PUSH[0][0]}-{SOLO12_PUSH[0][1]} s, "
                 "async at 0.02 s latency" if pushes else ", sync")
              + f": fell at {t_fall} s, mean vx {(qs[-1, 0] - qs[0, 0]) / seconds:.4f} m/s, base z "
              f"{qs[:, 2].min():.4f}..{qs[:, 2].max():.4f} (final {qs[-1, 2]:.4f}), max "
              f"|roll| {np.abs(qf[:, 5]).max():.4f} rad, second-half mean z "
              f"{qf[half:, 2].mean():.4f}, finite {bool(np.isfinite(qs).all())}, diverged "
              f"{mpc.diverged}; {latency(mpc, t_fall)}; wall {wall:.2f} s ({card})", flush=True)
        if not np.isfinite(qs).all() or mpc.diverged:
            fail(f"solo12 {name}: the closed loop diverged or went non-finite")
    solo12_gates(loops)
    launches = read(kernels)
    print(f"[solo12] launches {launches}; phase 22 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if min(launches[k] for k in ("dyncore", "lingram", "riccati_rollout", "dynjac")) <= 0:
        fail(f"solo12: a kernel of the path was not launched: {launches}")
    return launches


def restricted_phase(dev, card, kernels) -> dict:
    """Phase 23: contact-restricted MPC (Raibert footsteps), Go2 trot."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

    t_phase = time.perf_counter()
    zero(kernels)
    spec = go2_spec(device=dev)
    g = load_golden("go2_trot_raibert")
    # a B=512 batch of restricted parameters: the Raibert controller's own
    # (footsteps from each start's CoM and velocity) for the noisy starts;
    # the second half with a 3 cm patch radius (AcyclicMPC's 6 cm patches),
    # so the patch hinge is active where the feet are off their footsteps
    mpc = LocomotionMPC(spec, gait_name="trot", contact_planner="raibert", solve_async=False,
                        device=dev)
    mpc.set_command(g["v_des"])
    mpc._solve_plan = lambda params, node: params
    qb = noisy_starts(g["q0"], BATCH, np.random.default_rng(SEED))
    ps = [mpc.optimize(q, g["v0"]) for q in qb.astype(np.float64)]
    mpc.close()
    pb = stack_params(ps)
    half = BATCH // 2
    pb = pb.replace(patch_radius=torch.cat([pb.patch_radius[:half],
                                            torch.full_like(pb.patch_radius[half:], 0.03)]))
    solver = mpc.solver
    Xb, Ub = solver.cold_start(pb)
    step = solver.solve(Xb, Ub, pb, 1)
    finite = bool(torch.isfinite(step.U).all() and torch.isfinite(step.stats.cost).all())
    n_given = int(torch.all(pb.cnt_loc != 0, dim=-1).sum())
    print(f"[restricted] B={BATCH} Raibert parameters (restrict {float(pb.restrict.min())}.."
          f"{float(pb.restrict.max())}, {n_given} (foot, node) footsteps given, patch radius "
          f"1e3 / 0.03): RTI step from the cold start, mean cost "
          f"{float(step.stats.cost.mean()):.4f}, finite {finite}", flush=True)
    if not finite:
        fail("restricted: non-finite B=512 RTI step")
    report_checks("restricted", twin_checks(solver, Xb, Ub, pb))

    # the controller's first plan against the JAX golden
    mpc = LocomotionMPC(spec, gait_name="trot", contact_planner="raibert", solve_async=False,
                        device=dev)
    solve, seen = mpc._solve_plan, []
    mpc._solve_plan = lambda params, node: solve(seen.append(params) or params, node)
    mpc.set_command(g["v_des"])
    mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    du = rel(mpc._U_prev[0].cpu(), torch.as_tensor(g["U"]))
    d_loc = float(np.abs(mpc._last_cnt_loc - g["cnt_loc"]).max())
    d_ref = max(float(np.abs(mpc._last_base_ref - g["base_ref"]).max()),
                float(np.abs(mpc._last_base_ref_e - g["base_ref_e"]).max()))
    print(f"[restricted controller vs JAX] first plan rel|dU| {du:.2e} (gate {REL_GATE}), "
          f"cnt_loc {d_loc:.2e}, base_ref {d_ref:.2e} (<= 1e-6)", flush=True)
    if not (du <= REL_GATE and d_loc <= 1e-6 and d_ref <= 1e-6):
        fail(f"restricted first plan: rel|dU| {du:.2e}, cnt_loc {d_loc:.2e}, base_ref {d_ref:.2e}")
    # one B=1 restricted RTI step from that plan, by both routes
    p1 = seen[0].replace(lam_eq=mpc._lam_prev, lam_ineq=mpc._lami_prev)
    ok, text = b1_route_check(solver, mpc._X_prev, mpc._U_prev, p1)
    print(f"[restricted b1 step] from the first plan: {text}", flush=True)
    if not ok:
        fail(f"restricted B=1 step: {text}")

    # the closed loop, with phase 8's gates
    mpc = LocomotionMPC(spec, gait_name="trot", contact_planner="raibert", solve_async=False,
                        device=dev)
    mpc.set_command(np.array([V_DES, 0.0, 0.0]))
    qs, wall = plant_loop(dev, spec, mpc, g["q0"], LOOP_S)
    mpc.close()
    z, tilt = qs[:, 2], np.degrees(np.abs(qs[:, 4:6]))
    vx = (qs[-1, 0] - qs[0, 0]) / LOOP_S
    print(f"[restricted closed loop] Raibert footsteps, {LOOP_S} s at {V_DES} m/s on the "
          f"device plant: mean vx {vx:.4f} m/s, base z {z.min():.4f}..{z.max():.4f} m, max "
          f"|roll|,|pitch| {tilt.max():.2f} deg, finite {bool(np.isfinite(qs).all())}, diverged "
          f"{mpc.diverged}; {latency(mpc)}; wall {wall:.2f} s ({card})", flush=True)
    if not np.isfinite(qs).all() or mpc.diverged:
        fail("restricted closed loop diverged or went non-finite")
    if not (z.min() > 0.15 and z.max() < 0.45 and tilt.max() < 25.0 and vx > 0.2):
        fail(f"restricted closed loop: z {z.min():.3f}..{z.max():.3f}, tilt {tilt.max():.1f} "
             f"deg, vx {vx:.3f}")

    # the custom planner: one plan from a fixed footstep table
    gc = load_golden("go2_trot_custom")
    mpc = LocomotionMPC(spec, gait_name="trot", contact_planner="custom", solve_async=False,
                        device=dev)
    mpc.contact_planner.set_contact_locations(gc["table"])
    mpc.set_command(gc["v_des"])
    mpc.optimize(gc["q0"], gc["v0"])
    mpc.close()
    du_c = rel(mpc._U_prev[0].cpu(), torch.as_tensor(gc["U"]))
    d_c = float(np.abs(mpc._last_cnt_loc - gc["cnt_loc"]).max())
    print(f"[custom planner vs JAX] first plan rel|dU| {du_c:.2e} (gate {REL_GATE}), cnt_loc "
          f"{d_c:.2e}", flush=True)
    if not (du_c <= REL_GATE and d_c <= 1e-6):
        fail(f"custom planner first plan rel|dU| {du_c:.2e}, cnt_loc {d_c:.2e}")
    launches = read(kernels)
    print(f"[restricted] launches {launches}; phase 23 wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if min(launches[k] for k in ("dyncore", "lingram", "riccati_rollout", "dynjac")) <= 0:
        fail(f"restricted: a kernel of the path was not launched: {launches}")
    return launches


def acyclic_phase(dev, card, kernels) -> dict:
    """Phase 24: AcyclicMPC, patches and the standing hop."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.models import dynamics as dyn
    from iterative_learning_nmpc_tpu_torch.mpc.acyclic import AcyclicMPC
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

    t_phase = time.perf_counter()
    zero(kernels)
    spec = go2_spec(device=dev)
    g = load_golden("go2_acyclic")
    mpc = AcyclicMPC(spec, gait_name="trot", n_sqp_first=15, solve_async=False, device=dev)
    N = mpc.config_opt.n_nodes
    mpc.set_contact_sequence(g["seq"])
    mpc.set_patches(g["centers"], np.zeros(g["seq"].shape, np.float32), g["sizes"])
    mpc.set_command(np.array([0.2, 0.0, 0.0]), 0.0)
    plan = mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    X, U = mpc._X_prev[0], mpc._U_prev[0].cpu()
    # the consumed part at the gate, the horizon at tests/test_torch_acyclic.py's 1e-2
    steps = mpc.replanning_steps
    du0 = rel(U[0], torch.as_tensor(g["U_patch"][0]))
    dplan = max(rel(torch.as_tensor(plan[0][:steps]), torch.as_tensor(g["q_plan"][:steps])),
                rel(torch.as_tensor(plan[4][:steps]), torch.as_tensor(g["tau_ff"][:steps])))
    du = rel(U, torch.as_tensor(g["U_patch"]))
    feet = dyn.foot_positions(spec, X[:, :18]).cpu().numpy()[:, :, :2]
    cnt = mpc.acyclic_planner.get_sequence(0, N + 1).T
    dist = float((np.linalg.norm(feet - g["centers"][None, :, 0, :2], axis=2) * cnt).max())
    zp = plan[0][:, 2]
    print(f"[acyclic patches] 6 cm patches, 15 iterations: node 0 rel|dU| {du0:.2e}, first "
          f"{steps} ms of the plan {dplan:.2e} (gate {REL_GATE}), horizon {du:.2e} (<= 1e-2); "
          f"stance feet from their patch centres <= {dist:.4f} m (< 0.033), plan base z "
          f"{zp.min():.4f}..{zp.max():.4f}", flush=True)
    if not (du0 <= REL_GATE and dplan <= REL_GATE and du <= 1e-2):
        fail(f"acyclic patch plan vs golden: {du0:.2e} / {dplan:.2e} / {du:.2e}")
    if not (dist < 0.03 + 3e-3 and zp.min() > 0.18 and zp.max() < 0.42):
        fail(f"acyclic patch plan: feet {dist:.4f} m off, base z {zp.min():.3f}..{zp.max():.3f}")

    mpc = AcyclicMPC(spec, gait_name="trot", n_sqp_first=30, solve_async=False, device=dev)
    mpc.set_contact_sequence(g["hop_cnt"])
    mpc.set_command(np.array([0.0, 0.0, 0.0]), 0.0)
    mpc.optimize(g["q0"], g["v0"])
    X, U = mpc._X_prev[0].cpu().numpy(), mpc._U_prev[0].cpu().numpy()
    F = U[:, 18:].reshape(N, 4, 3)
    z0 = X[0, 2]
    du_h = rel(torch.as_tensor(U), torch.as_tensor(g["U_hop"]))
    print(f"[acyclic hop plan] flight forces max {np.abs(F[10:14]).max():.3e} (exactly 0), "
          f"apex {X[:, 2].max():.4f} m from {z0:.4f} (> +0.05), takeoff velocity "
          f"{X[11, 20]:.4f} m/s (> 0.2), rel|dU| vs golden {du_h:.2e} (gate {REL_GATE})",
          flush=True)
    if not (np.abs(F[10:14]).max() == 0.0 and X[:, 2].max() > z0 + 0.05 and X[11, 20] > 0.2):
        fail("acyclic hop plan fails its ballistic gates")
    if not du_h <= REL_GATE:
        fail(f"acyclic hop plan rel|dU| {du_h:.2e} > {REL_GATE}")
    qs, wall = plant_loop(dev, spec, mpc, g["q0"], HOP_S)
    mpc.close()
    qf = np.vstack(mpc.q_full)
    t_fall = fall_time(qs, mpc.config_gait.nom_height)
    print(f"[acyclic hop] {HOP_S} s on the device plant: fell at {t_fall} s, max z "
          f"{qf[:, 2].max():.4f} (> {z0 + 0.04:.4f}), final z {qf[-1, 2]:.4f} (0.25..0.33), "
          f"max |roll| {np.abs(qf[:, 5]).max():.4f} rad (< 0.05), finite "
          f"{bool(np.isfinite(qs).all())}, diverged {mpc.diverged}; {latency(mpc)}; wall "
          f"{wall:.2f} s ({card})", flush=True)
    if not np.isfinite(qs).all() or mpc.diverged or t_fall is not None:
        fail("acyclic hop: fell, diverged or went non-finite")
    if not (qf[:, 2].max() > z0 + 0.04 and 0.25 < qf[-1, 2] < 0.33
            and np.abs(qf[:, 5]).max() < 0.05):
        fail("acyclic hop: did not take off, land upright or keep its roll")
    launches = read(kernels)
    print(f"[acyclic] launches {launches}; phase 24 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if min(launches[k] for k in ("dyncore", "riccati_rollout", "dynjac")) <= 0:
        fail(f"acyclic: a kernel of the path was not launched: {launches}")
    return launches


def warmstart_phase(dev, card, kernels) -> dict:
    """Phase 25: the policy warm starts with the shipped policy (kernel 8 a
    node), at B=1 and B_ENV."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, load_policy
    from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver, make_params
    from iterative_learning_nmpc_tpu_torch.solver.warmstart import (
        phase_aligned_warmstart, phase_pick, policy_targets, policy_warmstart)
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    t_phase = time.perf_counter()
    g = load_golden("go2_trot_policy_warmstart")
    spec = go2_spec(device=dev)
    gait, opt, cost = get_quadruped_config("trot", "go2")
    solver = TrajOptSolver(spec, opt, cost, device=dev)
    N = solver.N
    served = ServedPolicy(*load_policy(os.path.join(ROOT, "assets", ARTIFACT), device=dev),
                          device=dev)
    if served.route != "kernel":
        fail(f"warm starts: the shipped policy is served on route {served.route}")
    apply_fn = policy_targets(served)
    p1 = make_params(solver, g["x0"][0], g["cnt"], base_ref=g["base_ref"],
                     step_height=gait.step_height, ground_height=float(spec.foot_radius))
    # the golden's 4 problems, then noisy standing starts up to B_ENV
    x0b = np.concatenate([g["x0"], np.concatenate(
        [noisy_starts(g["x0"][0, :18], B_ENV - 3, np.random.default_rng(SEED + 1))[1:],
         np.zeros((B_ENV - 4, 18), np.float32)], 1)])
    windows = torch.as_tensor(g["windows"], device=dev)
    out, launches = {}, {}
    for B in (1, B_ENV):
        p = p1.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
        p = p.replace(x0=torch.as_tensor(x0b[:B], device=dev))
        for name, fn in (("policy_warmstart", lambda: policy_warmstart(
                             solver, apply_fn, p, g["v_des"])),
                         ("phase_aligned_warmstart", lambda: phase_aligned_warmstart(
                             solver, apply_fn, p, g["v_des"], g["windows"]))):
            zero(kernels)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            res = fn()
            end.record()
            torch.cuda.synchronize()
            out[name, B] = (res, start.elapsed_time(end))
            launches[name, B] = read(kernels)
            if launches[name, B]["policy_pd"] != N:
                fail(f"{name} B={B}: kernel 8 launched {launches[name, B]['policy_pd']} "
                     f"times, not N = {N}")
        cold_ms = cuda_time_ms(lambda: solver.cold_start(p), 20)
        (X, U), ms_p = out["policy_warmstart", B]
        (X2, U2, p2, off), ms_a = out["phase_aligned_warmstart", B]
        # the JAX package's own spread between two compilations over the
        # first two nodes (tests/test_torch_warmstart.py): q 2.9e-2, v 0.56
        k = min(B, 4)
        ref = g["X_policy"][:k, :3]
        Xh = X[:k, :3].cpu().numpy()
        dq, dv = (float(np.abs(Xh[..., s] - ref[..., s]).max())
                  for s in (slice(0, 18), slice(18, 36)))
        sol = solver.solve(X2, U2, p2, 3)
        finite = all(bool(torch.isfinite(t).all()) for t in (X, U, X2, U2, sol.stats.cost))
        same = bool(torch.equal(X2, X))
        print(f"[warm starts] B={B}: policy_warmstart {ms_p:.1f} ms, phase_aligned_warmstart "
              f"{ms_a:.1f} ms, cold_start {cold_ms:.4f} ms (CUDA events; {card}); kernel 8 "
              f"launches {launches['policy_warmstart', B]['policy_pd']} and "
              f"{launches['phase_aligned_warmstart', B]['policy_pd']}; first two nodes of "
              f"problems 0..{k - 1} vs the JAX golden: q {dq:.2e} (<= 3e-2), v {dv:.2e} "
              f"(<= 0.6); offsets {off[:k].tolist()} (golden {g['offset'][:k].tolist()}, "
              f"informational: the JAX package compiled two ways differs in 3 of 4); same "
              f"rollout {same}; warm-started 3-iteration solve mean cost "
              f"{float(sol.stats.cost.mean()):.3f}, finite {finite}", flush=True)
        if not (dq <= 3e-2 and dv <= 0.6 and finite and same):
            fail(f"warm starts B={B}: q {dq:.2e}, v {dv:.2e}, finite {finite}, same {same}")
    # the phase pick, exact on the golden's node states
    Xg = torch.as_tensor(g["X_aligned"], device=dev)
    cp = device_sim.contact_params_for(spec, device=dev)
    off_g = phase_pick(device_sim.contact_forces(spec, Xg[:, 1:, :18], Xg[:, 1:, 18:], cp),
                       windows).cpu().numpy()
    (X1, U1), _ = out["policy_warmstart", 1]
    (Xb, Ub), _ = out["policy_warmstart", B_ENV]
    print(f"[warm starts] phase pick on the golden's node states {off_g.tolist()} (golden "
          f"{g['offset'].tolist()}); problem 0 at B={B_ENV} bit-equal to B=1: "
          f"{bool(torch.equal(Xb[:1], X1) and torch.equal(Ub[:1], U1))}; phase 25 wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not np.array_equal(off_g, g["offset"]):
        fail(f"warm starts: phase pick {off_g} != golden {g['offset']}")
    return {f"{name} B={B}": v["policy_pd"] for (name, B), v in launches.items()}

def scale_phase(dev, card, kernels) -> dict:
    """Phase 26: the randomized datagen (B_ENV envs, each plant with its
    payload and terrain, pushes on the second half) against the JAX run
    of the same draws; ``graft_entry.dryrun_multichip(1)`` in a NCCL
    process group of one rank; the datagen and DAgger CLIs as
    subprocesses, their npz read back. Returns the launches by part: the
    datagen's ("26"), the dryrun's ("26 dryrun") and the two CLIs' summed,
    as they print them ("26 cli")."""
    import socket
    import tempfile

    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.graft_entry import dryrun_multichip
    from iterative_learning_nmpc_tpu_torch.learning.database import Database
    from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu_torch.learning.randomize import (
        randomize_payload, randomize_terrain, sample_force_windows)
    from iterative_learning_nmpc_tpu_torch.parallel.mesh import (
        init_process_group, shutdown_distributed)
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    t_phase = time.perf_counter()
    g = load_golden("go2_trot_randomized_datagen")
    B, seed, n_int = g["x0"].shape[0], int(g["seed"]), int(g["n_intervals"])
    spec = go2_spec(device=dev)
    gen = lambda k: torch.Generator().manual_seed(seed + k)
    ps = randomize_payload(spec, gen(0), B)
    tr = randomize_terrain(gen(1), B, device=dev)
    fw = sample_force_windows(gen(2), B, n_int * 40, device=dev)
    fw[: B // 2] = 0.0
    draws = dict(mass=ps.mass, com=ps.com, ground_height=tr.ground_height,
                 stiffness=tr.contact.stiffness, damping=tr.contact.damping,
                 friction_mu=tr.contact.friction_mu, vel_smoothing=tr.contact.vel_smoothing,
                 force_windows=fw)
    differ = [k for k, v in draws.items() if not np.array_equal(v.cpu().numpy(), g[k])]
    if differ:
        fail(f"randomized datagen: the card's draws differ from the reference's in {differ}")
    # the payload plants alone against the JAX plant: no joint torque, each
    # env's push held on, q and v at the stored steps
    st = device_sim.SimState(torch.as_tensor(g["x0"][:, :18], device=dev),
                             torch.zeros(B, 18, device=dev), torch.zeros(B, device=dev))
    zero_tau, f_push = torch.zeros(B, 12, device=dev), fw[:, 2:5].contiguous()
    check, errs = [int(k) for k in g["plant_check"]], []
    for k in range(1, max(check) + 1):
        st = device_sim.step(ps, st, zero_tau, tr.contact, f_ext=f_push,
                             ground_height=tr.ground_height)
        if k in check:
            i = check.index(k)
            errs.append((k, float((st.q.cpu() - torch.as_tensor(g["plant_q"][i])).abs().max()),
                         float((st.v.cpu() - torch.as_tensor(g["plant_v"][i])).abs().max())))
    print(f"[payload plants vs JAX] {B} plants, no joint torque, pushes held on: max|dq|, "
          f"max|dv| at steps " + ", ".join(f"{k}: {dq:.2e}, {dv:.2e}" for k, dq, dv in errs)
          + f" (<= {PLANT_Q_TOL:.0e}, {PLANT_V_TOL:.0e})", flush=True)
    if any(dq > PLANT_Q_TOL or dv > PLANT_V_TOL for _, dq, dv in errs):
        fail("the payload plants differ from the JAX plant")
    datagen = make_batched_mpc_rollout(spec, n_intervals=n_int, device=dev)
    zero(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = datagen(g["x0"], g["v_des"], ps, tr, force_windows=fw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(kernels)
    T = rows.q.shape[1]
    valid_env = rows.valid.mean(1).cpu().numpy()
    pushed = np.arange(B) >= B // 2
    fell = valid_env < 1.0
    finite = all(bool(torch.isfinite(t).all()) for t in rows)
    z = (rows.q[..., 2] - tr.ground_height[:, None]).cpu().numpy()
    ref = float(g["valid_env"].mean())
    print(f"[randomized datagen] B={B} x {n_int} intervals ({T} control steps; payload 0-3 kg, "
          f"terrain, 50-70 N pushes on {int(pushed.sum())} envs): valid {valid_env.mean():.4f} "
          f"(push-free {valid_env[~pushed].mean():.4f}, pushed {valid_env[pushed].mean():.4f}; "
          f"JAX on the CPU, same draws, {ref:.4f}: gate |d| <= {RAND_VALID_MARGIN:.4f}), fell "
          f"{int(fell.sum())} (JAX {int(g['fell'].sum())}), base z above ground "
          f"{z.min():.4f}..{z.max():.4f}, finite {finite}; {B * T / wall:.1f} rows/s "
          f"({wall:.2f} s wall; nominal phase 12: {RATES['datagen']:.1f} rows/s; {card}), "
          f"launches {launches}", flush=True)
    if not (finite and abs(valid_env.mean() - ref) <= RAND_VALID_MARGIN):
        fail("randomized datagen: non-finite rows or valid share off the JAX run's")
    if min(launches[k] for k in ("dyncore", "lingram", "riccati_rollout")) <= 0:
        fail(f"randomized datagen did not launch kernels 1-3: {launches}")
    # the plant step on the payload spec, captured as one CUDA graph, against
    # the eager step from the rollout's last state
    step = lambda q, v, t, u: tuple(device_sim.step(
        ps, device_sim.SimState(q, v, t), u, tr.contact, f_ext=fw[:, 2:5],
        ground_height=tr.ground_height))
    args = (rows.q[:, -1].contiguous(), rows.v[:, -1].contiguous(),
            torch.zeros(B, device=dev), rows.tau[:, -1].contiguous())
    eager, replay = step(*args), device_sim.graphed(step, *args)(*args)
    same = all(torch.equal(a, b) for a, b in zip(eager, replay))
    print(f"[randomized datagen] the payload plant step as a CUDA graph: bit-equal to the "
          f"eager step {same}", flush=True)
    if not same:
        fail("the graphed payload plant step differs from the eager one")

    # dryrun_multichip(1) inside a real NCCL process group of one rank
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    init_process_group(f"127.0.0.1:{port}", 1, 0, device=dev, timeout=120.0)
    zero(kernels)
    try:
        dry = dryrun_multichip(1, device=dev)
    finally:
        shutdown_distributed()
    torch.cuda.synchronize()
    dry_launches = read(kernels)
    print(f"[dryrun_multichip(1)] backend {dry['backend']}, world size {dry['world_size']}: "
          f"{json.dumps(dry)}; launches {dry_launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if dry["backend"] != "nccl":
        fail(f"dryrun_multichip ran on {dry['backend']}, not NCCL")
    if min(dry_launches[k] for k in ("dyncore", "lingram", "riccati_rollout")) <= 0:
        fail(f"dryrun_multichip did not launch kernels 1-3: {dry_launches}")

    # the two CLIs, side by side on the card, each npz read back
    mod = "iterative_learning_nmpc_tpu_torch.examples."
    with tempfile.TemporaryDirectory(prefix="phase26_") as tmp:
        cmds = {
            "datagen": [sys.executable, "-m", mod + "ondevice_datagen", "--batch", str(CLI_B),
                        "--seconds", str(CLI_S), "--randomize", "--device", str(dev), "--out",
                        os.path.join(tmp, "datagen.npz")],
            "dagger": [sys.executable, "-m", mod + "ondevice_dagger", "--policy",
                       os.path.join(ROOT, "assets", ARTIFACT), "--batch", str(CLI_DAGGER_B),
                       "--sim_time", str(CLI_S), "--iters", "1", "--goals", f"{V_DES},0,0",
                       "--epochs", "1", "--delay_steps", str(DELAY_STEPS), "--mpc_min_steps",
                       str(MPC_MIN_STEPS), "--randomize", "--device", str(dev), "--out",
                       os.path.join(tmp, "dagger")]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for k, c in cmds.items()}
        logs = {}
        try:
            for k, p in procs.items():
                logs[k] = p.communicate(timeout=CLI_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            fail(f"a CLI ran past {CLI_TIMEOUT_S} s")
        for k, p in procs.items():
            if p.returncode != 0:
                fail(f"the {k} CLI exited {p.returncode}:\n{logs[k][-3000:]}")
        npz = {"datagen": os.path.join(tmp, "datagen.npz"),
               "dagger": next(ln.split(": ", 1)[1] for ln in logs["dagger"].splitlines()
                              if ln.startswith("final dataset: "))}
        cli, cli_launches = {}, dict.fromkeys(launches, 0)
        for k, path in npz.items():
            db = Database(limit=10 ** 7)
            db.load(path)
            line = [ln for ln in logs[k].splitlines() if "launches" in ln][-1]
            counts = {n: int(c) for n, c in re.findall(r"(\w+) (\d+)",
                                                       line.split("launches", 1)[1])}
            for n, c in counts.items():
                cli_launches[n] += c
            cli[k] = dict(rows=len(db), path=os.path.basename(path), launches=counts)
            print(f"[{k} CLI] {path} read back by Database.load: {len(db)} rows; launches "
                  f"{counts}", flush=True)
    print(f"[CLIs] {time.perf_counter() - t0:.1f} s side by side; phase 26 wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if min(c["rows"] for c in cli.values()) <= 0:
        fail(f"a CLI wrote no rows: {cli}")
    if min(cli["datagen"]["launches"].get(n, 0) for n in ("dyncore", "lingram",
                                                           "riccati_rollout")) <= 0 \
            or cli["dagger"]["launches"].get("policy_pd", 0) <= 0:
        fail(f"the datagen CLI did not launch kernels 1-3 or the DAgger CLI kernel 8: {cli}")
    return {"26": launches, "26 dryrun": dry_launches, "26 cli": cli_launches}


def solo12_gates(loops) -> None:
    """Phase 22's closed-loop gates. On the device plant the JAX controller
    does not keep Solo12 up: its base sinks below half the nominal height at
    SOLO12_REF's times, before the push window (the MuJoCo gates of the JAX
    package's tests/test_solo12_closed_loop.py hold only on MuJoCo). So the
    port is held to that run's numbers, with a margin: upright until the
    reference's fall less FALL_MARGIN_S, its roll there within 1.5x the
    reference's, its mean forward speed there within 0.12 m/s of the command
    (the MuJoCo gate's band)."""
    import numpy as np

    for name, (v_cmd, t_ref, roll_ref) in SOLO12_REF.items():
        qs = loops[name]["qs"][: int(round((t_ref - FALL_MARGIN_S) / 1e-3))]
        upright = fall_time(qs, loops[name]["nom"]) is None
        roll = float(np.abs(qs[:, 5]).max())
        vx = (qs[-1, 0] - qs[0, 0]) / (len(qs) * 1e-3)
        ok = upright and roll <= 1.5 * roll_ref and abs(vx - v_cmd) < 0.12
        print(f"[solo12 {name} gate] over the first {t_ref - FALL_MARGIN_S:.3f} s (the JAX "
              f"controller on the JAX device plant falls at {t_ref} s): upright {upright}, "
              f"max |roll| {roll:.4f} rad (<= {1.5 * roll_ref:.4f}), mean vx {vx:.4f} m/s "
              f"(|vx - {v_cmd}| < 0.12)", flush=True)
        if not ok:
            fail(f"solo12 {name}: outside the reference run's gates")


class CheckedPolicy:
    """A ``PolicyController`` whose every ``every``-th action is held to the
    kernel's plain twin on the CPU at the same input (phase 10's bound:
    |d act| <= 2e-5 + 2e-4 |act|); the twin's calls launch nothing."""

    diverged = False

    def __init__(self, pol, every):
        self.pol, self.every, self.k, self.errs = pol, every, 0, []
        self.host = [(W.cpu(), b.cpu()) for W, b in pol.served.layers]

    @property
    def torques_dof(self):
        return self.pol.torques_dof

    def compute_torques_dof(self, data):
        import numpy as np
        import torch

        from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd_plain

        self.pol.compute_torques_dof(data)
        if self.k % self.every == 0:
            T = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
            ap, _ = policy_pd_plain(self.host, self.pol.kp, self.pol.kd,
                                    T(self.pol.policy_input(data)), T(data.qpos[7:]),
                                    T(data.qvel[6:]))
            ap = ap[0].numpy().astype(np.float64)
            d = np.abs(self.pol.last_action - ap)
            self.errs.append((float(d.max()), bool((d <= 2e-5 + 2e-4 * np.abs(ap)).all())))
        self.k += 1


def switches(mode_log, dt=1e-3):
    """The times (s) at which a mode log changes mode (the first entry
    against "policy")."""
    import numpy as np

    m = np.asarray(mode_log, np.int8)
    return np.flatnonzero(np.diff(np.concatenate([[0], m]))) * dt


def host_loop_phase(dev, card, kernels) -> dict:
    """Phase 27: the host controllers (``learning/policy_controller.py``,
    ``learning/combined_controller.py``), Go2's push recovery and turning,
    and the MPC CLI, on the card. Returns the launches by part."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.learning.combined_controller import (
        CombinedController)
    from iterative_learning_nmpc_tpu_torch.learning.policy_controller import PolicyController
    from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd_dense
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

    t_phase = time.perf_counter()
    g = load_golden("go2_host_loop")
    spec = go2_spec(device=dev)
    q0 = g["plant_q0"]
    nom = get_quadruped_config("trot", spec.name)[0].nom_height
    path = os.path.join(ROOT, "assets", ARTIFACT)
    v_pol = np.array([HOST_V, 0.0, 0.0])
    total = dict.fromkeys((k.__name__ for k in kernels), 0)

    def add(counts):
        for k, c in counts.items():
            total[k] += c

    # (a) PolicyController at B=1 on the card, kernel 8 each control step
    sim = DevicePlantSimulator(spec, PlantGraph(spec, dev))
    pol = PolicyController(sim, path, v_des=v_pol, device=dev)
    checked = CheckedPolicy(pol, HOST_CHECK)
    zero(kernels)
    dense0 = policy_pd_dense.calls
    qs, wall = plant_loop(dev, spec, checked, q0, HOST_S, sim=sim)
    launches = read(kernels)
    add(launches)
    steps = int(round(HOST_S / 1e-3))
    served = launches["policy_pd"] if pol.served.route == "kernel" else (
        policy_pd_dense.calls - dense0)
    inf = np.asarray(pol.inference_ms)
    t_fall = fall_time(qs, nom)
    err = max(e for e, _ in checked.errs)
    print(f"[27 policy] PolicyController (route {pol.served.route}) at {HOST_V} m/s for "
          f"{HOST_S} s on the device plant: fell at {t_fall} s, x {qs[-1, 0]:.4f} m, z "
          f"{qs[:, 2].min():.4f}..{qs[:, 2].max():.4f}; {served} policy launches for {steps} "
          f"control steps; every {HOST_CHECK}th action against the CPU twin: max |d act| "
          f"{err:.3e} ({len(checked.errs)} checks, all within 2e-5 + 2e-4 |act| "
          f"{all(ok for _, ok in checked.errs)}); {wall / steps * 1e3:.3f} ms a control step, "
          f"inference_ms median {np.median(inf):.4f} p95 {np.percentile(inf, 95):.4f} "
          f"({card})", flush=True)
    if t_fall is not None:
        fail(f"27 policy: the policy fell at {t_fall} s")
    if served != steps:
        fail(f"27 policy: {served} policy launches ({pol.served.route}) for {steps} steps")
    if not all(ok for _, ok in checked.errs):
        fail(f"27 policy: an action outside phase 10's bound of its twin: {checked.errs}")

    # (b) CombinedController: policy + LocomotionMPC, pushed
    pushes = tuple((float(a), float(b), tuple(float(x) for x in f))
                   for a, b, *f in g["plant_comb_push"])
    v_comb = np.array([float(g["plant_comb_v"]), 0.0, 0.0])
    sim = DevicePlantSimulator(spec, PlantGraph(spec, dev))
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, device=dev)
    comb = CombinedController(sim, mpc, PolicyController(sim, path, v_des=v_comb, device=dev),
                              v_des=v_comb, delay_steps=int(g["delay_steps"]),
                              mpc_min_steps=int(g["mpc_min_steps"]))
    comb.set_command(v_comb)
    zero(kernels)               # after the policy's construction-time call
    qs, wall = plant_loop(dev, spec, comb, q0, HOST_S, pushes, sim=sim)
    mpc.close()
    launches = read(kernels)
    add(launches)
    sw, t_fall = switches(comb.mode_log), fall_time(qs, nom)
    print(f"[27 combined] CombinedController ({HOST_S} s at {v_comb[0]} m/s, pushed {pushes}, "
          f"delay {int(g['delay_steps'])}, latch {int(g['mpc_min_steps'])}): fell at {t_fall} "
          f"s, switches at {np.round(sw, 3).tolist()} s ({int(np.sum(comb.mode_log))} expert "
          f"steps; the JAX run {np.round(g['plant_comb_switch'], 3).tolist()} s, "
          f"{int(g['plant_comb_expert_steps'])} steps; without the push "
          f"{np.round(g['plant_comb_nopush_switch'], 3).tolist()} s); x {qs[-1, 0]:.4f} m "
          f"(JAX {g['plant_comb_qs'][-1, 0]:.4f}); {latency(mpc)}; {wall / steps * 1e3:.3f} "
          f"ms a control step; launches {launches} ({card})", flush=True)
    if not np.any(comb.mode_log):
        fail("27 combined: the expert never took over")
    if t_fall is not None or mpc.diverged:
        fail(f"27 combined: fell at {t_fall} s or diverged ({mpc.diverged})")
    if min(launches[k] for k in ("dyncore", "lingram", "riccati_rollout", "dynjac")) <= 0 \
            or launches["policy_pd"] != steps:
        fail(f"27 combined: a kernel of the path was not launched, or kernel 8 not once a "
             f"control step: {launches}")

    # (c) Go2's push recovery and turning on the device plant
    for name, v, w, seconds, pushes in (("push", 0.0, 0.0, PUSH_S, PUSH),
                                        ("turn", TURN_V, TURN_W, TURN_S, ())):
        zero(kernels)
        mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, device=dev)
        mpc.set_command(np.array([v, 0.0, 0.0]), w)
        qs, wall = plant_loop(dev, spec, mpc, q0, seconds, pushes)
        mpc.close()
        launches = read(kernels)
        add(launches)
        t_fall, every = fall_time(qs, nom), int(g["every"])
        ref = g[f"{name}_qs"]
        early = int(round(0.3 / (every * 1e-3)))
        d_early = float(np.abs(qs[::every][:early] - ref[:early]).max())
        yaw, yaw_ref = float(qs[-1, 3]), float(g[f"{name}_yaw"])
        tilt = np.abs(qs[-1, 4:6])
        print(f"[27 {name}] LocomotionMPC {seconds} s at {v} m/s, w_yaw {w}"
              + (f", {pushes[0][2]} N over {pushes[0][0]}-{pushes[0][1]} s" if pushes else "")
              + f": fell at {t_fall} s (JAX {g[name + '_fall']}), final z {qs[-1, 2]:.4f} "
              f"(JAX {ref[-1, 2]:.4f}), yaw {yaw:.4f} (JAX {yaw_ref:.4f}, |d| "
              f"{abs(yaw - yaw_ref):.4f} <= {TURN_YAW_TOL} for the turn), final |pitch|, |roll| "
              f"{tilt[0]:.4f}, {tilt[1]:.4f}; base states over the first 0.3 s within "
              f"{d_early:.2e} of the JAX run's; {latency(mpc)}; wall {wall:.2f} s; launches "
              f"{launches} ({card})", flush=True)
        if t_fall is not None or mpc.diverged or not np.isfinite(qs).all():
            fail(f"27 {name}: fell at {t_fall} s, diverged or non-finite")
        if min(launches[k] for k in ("dyncore", "lingram", "riccati_rollout", "dynjac")) <= 0:
            fail(f"27 {name}: a kernel of the path was not launched: {launches}")
        if name == "push" and not 0.2 < qs[-1, 2] < 0.4:
            fail(f"27 push: final base height {qs[-1, 2]:.4f} outside (0.2, 0.4)")
        if name == "turn" and not (yaw > 0.4 and (tilt < 0.3).all()
                                   and abs(yaw - yaw_ref) <= TURN_YAW_TOL):
            fail(f"27 turn: yaw {yaw:.4f} (JAX {yaw_ref:.4f}), tilt {tilt}")

    # (d) the MPC CLI: traj_opt and a short open loop, side by side
    mod = "iterative_learning_nmpc_tpu_torch.examples.run_mpc"
    cmds = {"traj_opt": [sys.executable, "-m", mod, "--mode", "traj_opt", "--device", str(dev)],
            "open_loop": [sys.executable, "-m", mod, "--mode", "open_loop", "--sim_time",
                          str(OPEN_LOOP_S), "--device", str(dev)]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, c in cmds.items()}
    logs = {}
    try:
        for k, p in procs.items():
            logs[k] = p.communicate(timeout=CLI_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        for p in procs.values():
            p.kill()
            p.communicate()
        fail(f"a run_mpc CLI ran past {CLI_TIMEOUT_S} s")
    cli = dict.fromkeys(total, 0)
    for k, p in procs.items():
        if p.returncode != 0:
            fail(f"run_mpc --mode {k} exited {p.returncode}:\n{logs[k][-3000:]}")
        line = [ln for ln in logs[k].splitlines() if ln.startswith("launches")][-1]
        counts = {n: int(c) for n, c in re.findall(r"(\w+) (\d+)", line.split(":", 1)[1])}
        for n, c in counts.items():
            cli[n] += c
        summary = [ln for ln in logs[k].splitlines()
                   if ln.startswith(("base z range", "|tau_ff|", "final base"))]
        print(f"[27 cli] run_mpc --mode {k}: {'; '.join(summary)}; launches {counts}",
              flush=True)
        if min(counts.get(n, 0) for n in ("dyncore", "riccati_rollout", "dynjac")) <= 0:
            fail(f"run_mpc --mode {k} did not launch kernels 1, 3 and 7: {counts}")
    print(f"[27] CLIs {time.perf_counter() - t0:.1f} s side by side; launches {total}; phase 27 "
          f"wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"27": total, "27 cli": cli}


# ---------------------------------------------------------------------------
# phase 28: the host-side learning pipeline on the card, the device plant in
# MuJoCo's place
def step_split(res, graph, steps) -> str:
    """A collector run's control step split into its plant graphs (timed
    inside ``PlantGraph``), its replans (``res.replan_ms``) and the rest,
    the host's, in ms a control step."""
    import numpy as np

    wall, plant = res.wall_s * 1e3 / steps, graph.busy_s * 1e3 / steps
    replan = float(np.sum(res.replan_ms)) / steps
    return (f"a control step {wall:.3f} ms = plant graphs {plant:.3f} ms ({graph.calls} steps, "
            f"{graph.busy_s * 1e3 / max(graph.calls, 1):.4f} ms each) + replans {replan:.3f} ms "
            f"+ host {wall - plant - replan:.3f} ms")


def replay_latch(monitor, n):
    """A fresh ``SwitchLatch`` (phase 28's delay and latch) over one env's
    monitor log: the modes of its first n steps, None where the replay
    consults a step the collector's latch did not."""
    from iterative_learning_nmpc_tpu_torch.learning.combined_controller import SwitchLatch

    latch, out = SwitchLatch(DELAY_STEPS, MPC_MIN_STEPS), []
    for s in range(n):
        read = []

        def unsafe(s=s):
            read.append(int(monitor[s]))
            return monitor[s] == 1

        out.append(latch.update(unsafe) == "mpc")
        if read and read[0] < 0:
            return None
    return out


def learning_pipeline_phase(dev, card, kernels) -> dict:
    """Phase 28: the host-side learning pipeline (``learning/plant_batch``,
    ``learning/datagen``, ``learning/dagger``'s pipeline, the train_bc CLI)
    on the card, each part with the counters set to 0 before it and read
    after it. Returns the launches by part."""
    import tempfile
    import types

    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.learning import plant_batch, rollouts
    from iterative_learning_nmpc_tpu_torch.learning.dagger import (
        SafeDaggerConfig, SafeDaggerPipeline)
    from iterative_learning_nmpc_tpu_torch.learning.database import Database
    from iterative_learning_nmpc_tpu_torch.learning.datagen import (
        DataCollection, DataCollectionConfig)
    from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, read_payload
    from iterative_learning_nmpc_tpu_torch.learning.rollouts import ForceWindow
    from iterative_learning_nmpc_tpu_torch.learning.train import TrainConfig
    from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore_plain
    from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac_plain
    from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram_plain
    from iterative_learning_nmpc_tpu_torch.ops.riccati import riccati_rollout_plain
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver
    from iterative_learning_nmpc_tpu_torch.utils.config_io import load_config

    t_phase = time.perf_counter()
    spec = go2_spec(device=dev)
    graph = PlantGraph(spec, dev)
    gap = graph.eager_gap()
    if gap != 0.0:
        fail(f"28: the plant graph is {gap} off the eager step")
    total = dict.fromkeys((k.__name__ for k in kernels), 0)

    def add(counts):
        for k, c in counts.items():
            total[k] += c

    # the device plant as the Simulator the pipeline builds
    installed = {m: m.Simulator for m in (plant_batch, rollouts)}
    for m in installed:
        m.Simulator = lambda spec, **kw: DevicePlantSimulator(spec, graph)
    print("[28] DevicePlantSimulator (the device plant, one CUDA graph a step, bit-equal to the "
          "eager step on 5 near-standing inputs) installed as learning.plant_batch.Simulator "
          "and learning.rollouts.Simulator", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_28_")
    try:
        # (a) the batched collector, expert-only, one batched plan at B=E
        v_des = np.zeros((PB_E, 3))
        v_des[:, 0] = np.tile(PB_GOALS, PB_E // len(PB_GOALS) + 1)[:PB_E]
        coll = plant_batch.BatchedPlantCollector(spec, n_envs=PB_E, device=dev)
        first = {}
        plan = coll.mpc._plan

        def keep_first(*a):
            out = plan(*a)
            if not first:
                first["args"], first["out"] = a, out
            return out

        coll.mpc._plan = keep_first
        zero(kernels)
        torch.cuda.synchronize()
        graph.calls, graph.busy_s = 0, 0.0
        res = coll.collect(v_des, sim_time=PB_S, joint_noise=PB_NOISE, seed=PB_SEED)
        split = step_split(res, graph, int(round(PB_S / 1e-3)))
        launches = read(kernels)
        add(launches)
        coll.mpc._plan = plan

        class PlainSolver(TrajOptSolver):
            lingram = staticmethod(lingram_plain)
            dynjac = staticmethod(dynjac_plain)
            riccati_rollout = staticmethod(riccati_rollout_plain)
            dyncore = staticmethod(dyncore_plain)

        m = coll.mpc
        plain = types.SimpleNamespace(
            solver=PlainSolver(m.spec, m.config_opt, m.config_cost, device=dev),
            config_opt=m.config_opt, n_interp_plan=m.n_interp_plan, n_foot=m.n_foot,
            spec=m.spec)
        out_p = LocomotionMPC._plan(plain, *first["args"])
        k = coll.keep
        cat = lambda o: torch.cat([o[2][0][:, :k], o[2][1][:, :k], o[2][4][:, :k]], -1)
        du = rel(first["out"][0].U, out_p[0].U)
        dplan = rel(cat(first["out"]), cat(out_p))
        coll.close()
        steps = int(round(PB_S / 1e-3))
        rep = np.asarray(res.replan_ms)
        print(f"[28 collector] expert-only, E={PB_E}, {PB_S} s, goals {PB_GOALS}: "
              f"{len(res.state)} rows, fell {int(res.fell.sum())}, expert ratio "
              f"{res.expert_ratio:.4f}; {res.env_sim_s:.2f} env-sim-s in {res.wall_s:.2f} s = "
              f"{res.env_sim_s / res.wall_s:.4f} env-sim-s per s, {res.wall_s / steps * 1e3:.2f} "
              f"ms a control step, replan at B={PB_E} {rep[0]:.1f} ms first (cold, "
              f"{m.config_opt.max_iter_first} iterations), median {np.median(rep[1:]):.2f} ms "
              f"after; first batched plan against the plain twins on the card: rel|dU| "
              f"{du:.2e}, consumed interval {dplan:.2e} (gate {REL_GATE}); {split}; launches "
              f"{launches} ({card})", flush=True)
        if res.fell.any() or not res.is_expert.all() or len(res.state) != PB_E * steps:
            fail(f"28 collector: fell {res.fell.tolist()}, expert {res.is_expert.mean()}, rows "
                 f"{len(res.state)} != {PB_E * steps}")
        if min(launches[n] for n in ("dyncore", "lingram", "riccati_rollout")) <= 0 \
                or launches["dynjac"] != 0:
            fail(f"28 collector: kernels 1, 2, 3 must launch and kernel 7 not: {launches}")
        if not (du <= REL_GATE and dplan <= REL_GATE):
            fail(f"28 collector: first plan rel {du:.2e} / {dplan:.2e} > {REL_GATE}")
        RATES["plant_batch"] = res.env_sim_s / res.wall_s

        # (b) combined: the shipped policy served at B=E, phase 27's push on
        # the odd envs
        path = os.path.join(ROOT, "assets", ARTIFACT)
        g = load_golden("go2_host_loop")
        a, b, *f = g["plant_comb_push"][0]
        push = ForceWindow(float(a), float(b), np.asarray(f, np.float64))
        sample = plant_batch.sample_force_perturbation
        plant_batch.sample_force_perturbation = lambda *_a, **_k: push
        coll = plant_batch.BatchedPlantCollector(spec, n_envs=PB_E, policy_path=path,
                                                 delay_steps=DELAY_STEPS,
                                                 mpc_min_steps=MPC_MIN_STEPS, device=dev)
        zero(kernels)
        graph.calls, graph.busy_s = 0, 0.0
        try:
            res = coll.collect(v_des, sim_time=PB_COMB_S, joint_noise=PB_NOISE, seed=PB_SEED,
                               n_pushes=1)
            split = step_split(res, graph, res.monitor.shape[1])
        finally:
            plant_batch.sample_force_perturbation = sample
            coll.close()
        launches = read(kernels)
        add(launches)
        steps = res.monitor.shape[1]
        replay_ok, pushed_expert = [], []
        for e in range(PB_E):
            lab = res.is_expert[res.env_id == e].astype(bool)
            replay_ok.append(replay_latch(res.monitor[e], len(lab)) == lab.tolist())
            if e % 2:
                pushed_expert.append(bool(lab.any()))
        print(f"[28 collector combined] E={PB_E}, {PB_COMB_S} s, delay {DELAY_STEPS}, latch "
              f"{MPC_MIN_STEPS}, pushed {push.force.tolist()} N over {push.start}-{push.end} s "
              f"on the odd envs: {len(res.state)} rows, fell {int(res.fell.sum())}, expert ratio "
              f"{res.expert_ratio:.4f}; policy_pd launches {launches['policy_pd']} for {steps} "
              f"control steps; labels equal a SwitchLatch replay of the monitor in "
              f"{sum(replay_ok)}/{PB_E} envs; expert in {sum(pushed_expert)}/{len(pushed_expert)} "
              f"pushed envs; {res.env_sim_s / res.wall_s:.4f} env-sim-s per s, "
              f"{res.wall_s / steps * 1e3:.2f} ms a control step, replan median "
              f"{np.median(res.replan_ms[1:]):.2f} ms; {split}; launches {launches} ({card})",
              flush=True)
        if launches["policy_pd"] != steps:
            fail(f"28 combined: {launches['policy_pd']} policy_pd launches for {steps} steps")
        if not all(replay_ok) or not any(pushed_expert):
            fail(f"28 combined: latch replay {replay_ok}, pushed-env expert {pushed_expert}")

        # (c) DataCollection.run: one nominal rollout, pushed restarts
        rec = os.path.join(tmp, "dc")
        cfg = DataCollectionConfig(record_dir=rec, sim_time_nominal=DC_NOMINAL_S,
                                   sim_time_perturbed=DC_PERTURBED_S, v_des=(DC_V, 0.0, 0.0),
                                   replan_freq_steps=DC_GRID, num_perturbations_per_replanning=1,
                                   max_retries=5)
        zero(kernels)
        t0 = time.perf_counter()
        dc_path = DataCollection(spec, cfg, device=dev).run()
        wall_dc = time.perf_counter() - t0
        launches = read(kernels)
        add(launches)
        kept = [p for p in sorted(os.listdir(rec)) if p.startswith("traj_")]
        n_kept = sum(len(np.load(os.path.join(rec, p))["time"]) for p in kept)
        db = Database(limit=10**6)
        db.load(dc_path)
        print(f"[28 datagen] DataCollection.run, Go2 trot at {DC_V} m/s, nominal {DC_NOMINAL_S} "
              f"s, replanning points every {DC_GRID} steps, pushed restarts of "
              f"{DC_PERTURBED_S} s: kept {kept}, {len(db)} rows in {os.path.basename(dc_path)} "
              f"(sum of the kept rollouts {n_kept}); wall {wall_dc:.2f} s; launches {launches} "
              f"({card})", flush=True)
        if len(db) != n_kept or len(kept) < 2:
            fail(f"28 datagen: {len(db)} rows for {n_kept} kept rows in {kept}")
        if min(launches[n] for n in ("dyncore", "riccati_rollout", "dynjac")) <= 0:
            fail(f"28 datagen: kernels 1, 3 and 7 must launch: {launches}")

        # (d) SafeDaggerPipeline.run: one goal, one iteration, onto (c)'s rows
        scfg = SafeDaggerConfig(record_dir=os.path.join(tmp, "sd"), sim_time=SD_S,
                                goals=((SD_V, 0.0, 0.0),), n_iterations_per_goal=1,
                                batch_size=SD_BATCH, n_epochs=SD_EPOCHS,
                                delay_steps=DELAY_STEPS, mpc_min_steps=MPC_MIN_STEPS)
        zero(kernels)
        t0 = time.perf_counter()
        pipe = SafeDaggerPipeline(spec, scfg, path, initial_dataset=dc_path, device=dev)
        final = pipe.run()
        wall_sd = time.perf_counter() - t0
        launches = read(kernels)
        add(launches)
        tag_dir = os.path.join(scfg.record_dir, "goal0_iter0")
        traj = np.load(os.path.join(tag_dir, [p for p in os.listdir(tag_dir)
                                              if p.startswith("traj_")][0]))
        n_exp = int(traj["is_expert"].sum())
        agg = Database(limit=10**6)
        agg.load(pipe.dataset_path)
        with open(os.path.join(scfg.record_dir, "policies", "metrics_goal0_iter0.jsonl")) as fh:
            metrics = [json.loads(ln) for ln in fh]
        served = ServedPolicy(*policy_from_numpy(read_payload(final), device=dev), device=dev)
        pp0 = read(kernels)["policy_pd"]
        x = torch.as_tensor(db.training_arrays()[0][:8], device=dev)
        act, _ = served.serve(x, torch.zeros(8, 12, device=dev), torch.zeros(8, 12, device=dev),
                              20.0, 1.5)
        torch.cuda.synchronize()
        pp = read(kernels)["policy_pd"] - pp0
        print(f"[28 pipeline] SafeDaggerPipeline.run, goal ({SD_V}, 0, 0), 1 iteration, {SD_S} s, "
              f"onto {len(db)} rows: expert ratio {pipe.collector.expert_ratio_history[0]:.4f} "
              f"({n_exp} expert rows), aggregate {len(agg)} rows; BC {SD_EPOCHS} epochs, batch "
              f"{SD_BATCH} on {pipe.device}: train loss {metrics[0]['train_loss']:.5f} -> "
              f"{metrics[-1]['train_loss']:.5f}, step_ms {metrics[-1].get('step_ms')}; the new "
              f"policy (route {served.route}) served, {pp} kernel 8 launch, finite "
              f"{bool(torch.isfinite(act).all())}; wall {wall_sd:.2f} s; launches {launches} "
              f"({card})", flush=True)
        if len(agg) != len(db) + n_exp or n_exp <= 0:
            fail(f"28 pipeline: aggregate {len(agg)} != {len(db)} + {n_exp} expert rows")
        if final == path or "step_ms" not in metrics[-1] or len(metrics) != SD_EPOCHS:
            fail(f"28 pipeline: no training on the card ({final}, {metrics[-1]})")
        if served.route != "kernel" or pp != 1 or not bool(torch.isfinite(act).all()):
            fail(f"28 pipeline: the new policy did not serve through kernel 8 ({served.route}, "
                 f"{pp} launches)")
        if min(launches[n] for n in ("dyncore", "riccati_rollout", "dynjac", "policy_pd")) <= 0:
            fail(f"28 pipeline: kernels 1, 3, 7 and 8 must launch: {launches}")

        # (e) the train_bc CLI on (c)'s snapshot, as a subprocess
        save = os.path.join(tmp, "bc")
        cmd = [sys.executable, "-m", "iterative_learning_nmpc_tpu_torch.examples.train_bc",
               "--dataset", dc_path, "--epochs", str(TRAIN_EPOCHS), "--batch_size", "256",
               "--save_dir", save, "--run_name", "smoke", "--device", str(dev)]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"train_bc ran past {CLI_TIMEOUT_S} s")
        if r.returncode != 0:
            fail(f"train_bc exited {r.returncode}:\n{(r.stdout + r.stderr)[-3000:]}")
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("launches")][-1]
        cli = dict.fromkeys(total, 0)
        cli.update({n: int(c) for n, c in re.findall(r"(\w+) (\d+)", line.split(":", 1)[1])})
        cfg_t = load_config(TrainConfig, os.path.join(save, "config_smoke.yaml"))
        want = TrainConfig(n_epochs=TRAIN_EPOCHS, batch_size=256, save_dir=save,
                           run_name="smoke")
        print(f"[28 cli] train_bc on {os.path.basename(dc_path)}: "
              + "; ".join(ln for ln in r.stdout.splitlines() if ln.startswith("final policy"))
              + f"; config_smoke.yaml read back by the port's load_config equal "
              f"{cfg_t == want}; {time.perf_counter() - t0:.1f} s; launches {cli}", flush=True)
        if cfg_t != want or not os.path.exists(os.path.join(save, "policy_smoke_final.pkl")):
            fail(f"train_bc: config {cfg_t} != {want} or no final policy")
    finally:
        for m_, sim in installed.items():
            m_.Simulator = sim
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[28] launches {total}; phase 28 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"28": total, "28 cli": cli}


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
    # ---- 22-25. Solo12, contact-restricted MPC, AcyclicMPC, the warm starts ----
    by_phase = {"22": solo12_phase(dev, card, kernels),
                "23": restricted_phase(dev, card, kernels),
                "24": acyclic_phase(dev, card, kernels)}
    ws = warmstart_phase(dev, card, kernels)
    # ---- 26. randomized datagen, the sharded dryrun, the CLIs ----
    by_phase.update(scale_phase(dev, card, kernels))
    # ---- 27. the host controllers, push recovery and turning, run_mpc ----
    by_phase.update(host_loop_phase(dev, card, kernels))
    # ---- 28. the host-side learning pipeline on the device plant ----
    by_phase.update(learning_pipeline_phase(dev, card, kernels))
    for r in results:
        r["launches_by_phase"] = {ph: c[r["name"]] for ph, c in by_phase.items()}
    next(r for r in results if r["name"] == "policy_pd")["launches_by_phase"]["25"] = ws
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
