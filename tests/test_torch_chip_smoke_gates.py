"""chip_smoke.py's memory gate on the fleet's pool (``cluster_serve``),
on the CPU: what it lets through and what it catches, at the Llama-3-8B
width's figures on the H100 (16.06 GB of bf16 weights, one engine alone
peaking at 23.09 GB, PERF.md)."""
import pytest

import chip_smoke

GB = 1e9
WEIGHTS, LONE = 16.06 * GB, 23.09 * GB


@pytest.mark.parametrize("peak_gb", [23.09, 26.18, 26.25, 29.5])
def test_two_replicas_transients_overlapping_or_not_pass(peak_gb):
    """The pool's peak is the weights once plus whatever the two
    replicas' transients add where they overlap in time: anywhere from
    one engine's (23.09 GB) to both (~30 GB) passes, as 26.18 and
    26.25 GB did not under the old 1.5 x the weights."""
    bound = chip_smoke.cluster_peak_bound(WEIGHTS, LONE)
    assert peak_gb * GB < bound
    assert 26.18 * GB >= 1.5 * WEIGHTS


@pytest.mark.parametrize("lone_gb", [17.0, 23.09, 40.0])
def test_a_second_copy_of_the_weights_never_passes(lone_gb):
    """A replica holding its own copy puts the weights twice on the
    card, which the bound never admits, however large the lone engine's
    transient; nor does the idle gate (half the weights above the card
    before the pool)."""
    bound = chip_smoke.cluster_peak_bound(WEIGHTS, lone_gb * GB)
    assert bound <= 2 * WEIGHTS
    assert bound >= WEIGHTS
    assert 0 < chip_smoke.CLUSTER_IDLE_OVER_WEIGHTS < 1   # a copy adds 1x


def test_the_bound_is_two_lone_transients_with_slack():
    transient = LONE - WEIGHTS
    assert chip_smoke.cluster_peak_bound(WEIGHTS, LONE) == pytest.approx(
        WEIGHTS + 2 * chip_smoke.CLUSTER_TRANSIENT_SLACK * transient)
    assert chip_smoke.cluster_peak_bound(WEIGHTS, WEIGHTS / 2) == WEIGHTS
