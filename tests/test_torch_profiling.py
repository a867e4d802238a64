"""The arithmetic of `genjax_tpu_torch.profiling` on a hand-made trace;
the trace itself needs a CUDA card and is taken by running the module."""

import pytest
import torch

from genjax_tpu_torch.profiling import busy_us, summarize

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "intervals, expected",
    [
        ([], 0.0),
        ([(0.0, 1.0)], 1.0),
        ([(0.0, 4.0), (1.0, 2.0)], 4.0),  # nested
        ([(3.0, 5.0), (0.0, 1.0), (4.0, 6.0)], 4.0),  # unsorted, overlapping
        ([(0.0, 1.0), (1.0, 2.0)], 2.0),  # touching
    ],
)
def test_busy_is_the_length_of_the_union(intervals, expected):
    assert busy_us(intervals) == expected


def test_summary_of_a_trace():
    # Exact: every number is a sum or ratio of small binary fractions.
    items = [("a", 0.0, 500.0), ("b", 250.0, 750.0), ("a", 1000.0, 1500.0)]
    s = summarize(items, launch_calls=6, wall_ms=4.0, steps=2, top=1)
    assert s["device_busy_ms"] == 1.25
    assert s["idle_share"] == 1.0 - 1.25 / 4.0
    assert s["device_items_per_step"] == 1.5
    assert s["launch_calls_per_step"] == 3.0
    assert s["largest"] == [{"name": "a", "count": 2, "ms": 1.0, "share_of_busy": 0.8}]
    assert s["k1_launches"] == 0 and s["k1_device_kernels"] == 0 and s["softmax_items"] == 0


def test_summary_counts_k1_kernels_and_softmax_items():
    items = [
        ("void (anonymous namespace)::genjax_lse<true>(float const*, long, float4*, unsigned int*, float*)", 0.0, 2.0),
        ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>(...)", 2.0, 4.0),
        ("void (anonymous namespace)::genjax_lse<false>(float const*, long, float4*, unsigned int*, float*)", 4.0, 5.0),
    ]
    s = summarize(items, launch_calls=3, wall_ms=1.0, steps=1, k1_launches=2)
    assert (s["k1_launches"], s["k1_device_kernels"], s["softmax_items"]) == (2, 2, 1)
