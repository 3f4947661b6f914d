"""The frozen operation counts equal the port's hand counts
(``ops/probes.py``) at the cells' shapes, and the shares stay below 100 %
of what the chip could do."""
import pytest

from port_bench import roofline


@pytest.mark.parametrize("B,N", [(1024, 100), (4096, 25), (512, 25)])
def test_counts_equal_the_ports_hand_counts(B, N):
    from iterative_learning_nmpc_tpu_torch.ops import probes

    assert roofline.flops_lingram(B, N) == probes.algo_flops_lingram(B, N)
    assert roofline.flops_riccati(B, N) == probes.algo_flops_riccati(B, N)
    assert roofline.flops_riccati(B, N, False) == probes.algo_flops_riccati(B, N, rollout=False)
    M = 2 * B * (N + 1)
    assert roofline.flops_dyncore(M) == probes.algo_flops_dyncore(M)
    assert roofline.flops_rollout(B, N) == pytest.approx(2.0 * (30 * 36 + 3 * 36) * B * N)


def test_pass_is_the_sum_of_its_kernels():
    ks = roofline.kernels(1024, 100, 2, fused=False)
    assert set(ks) == {"lingram", "riccati_sweep_terminal", "forward_rollout", "dyncore"}
    assert roofline.pass_least_s(1024, 100, 2, False) == pytest.approx(
        sum(roofline.least_s(f, b) for f, b in ks.values()))
    assert set(roofline.kernels(4096, 25, 2, fused=True)) == {"lingram", "riccati_rollout", "dyncore"}
    # the blocks dominate the bytes: 3,342 floats a node
    assert roofline.bytes_lingram(1, 1) == 4 * (36 + 30 + 104 + 3342)
