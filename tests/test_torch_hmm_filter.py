"""The 64-state discrete HMM's bootstrap filter (`models/hmm.py::hmm_filter`)
against the benchmark's plain reference (`benchmarks/reference/
discrete_hmm_filter.py`, loaded by path) on the CPU: the reference's
tables equal `DiscreteHMMConfiguration`'s bit for bit, its float64 forward
algorithm gives `exact_log_marginal`'s LML, the port's mean LML lies
within 5 standard errors of the exact value and of the reference filter's
mean, its final states are as close to the exact filtering marginal as
the reference filter's at the same K, the categorical's counters count
three rows of 64 a particle-step, and the filter's ESS threshold sets
the gate. On the card (marked `gpu`, skipped without one; run there with
`python -m pytest --noconftest -m gpu tests/test_torch_hmm_filter.py`),
the filter at K = 65536 with every categorical row through K4 meets the
exact LML and final-state marginal as the CPU runs do.
"""

import dataclasses
import importlib.util
import math
import statistics
from pathlib import Path

import pytest
import torch

from genjax_tpu_torch.distributions import library
from genjax_tpu_torch.distributions.discrete_hmm import DiscreteHMMConfiguration
from genjax_tpu_torch.inference import particle_filter
from genjax_tpu_torch.models.hmm import exact_log_marginal, hmm_filter

REFERENCE = Path(__file__).resolve().parent.parent / "benchmarks" / "reference" / "discrete_hmm_filter.py"
CONFIG = {
    "n_states": 64, "adjacency_trans": 2, "adjacency_obs": 2, "sigma_trans": 0.5, "sigma_obs": 0.5,
    "initial_state": 32, "resampling": "systematic", "ess_threshold": 0.5,
}
K, T, RUNS = 1024, 50, 12


def _load_reference():
    spec = importlib.util.spec_from_file_location("discrete_hmm_filter_reference", REFERENCE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load_reference()


def _hmm() -> DiscreteHMMConfiguration:
    c = CONFIG
    return DiscreteHMMConfiguration(c["n_states"], c["adjacency_trans"], c["adjacency_obs"], c["sigma_trans"], c["sigma_obs"])


def _observations(steps: int = T) -> torch.Tensor:
    return ref.make_inputs(CONFIG, {"datasets": 1, "steps": steps}, 2**31 + 21, "cpu")["observations"][0]


def _filter(n: int = K):
    return hmm_filter(_hmm(), CONFIG["initial_state"], n, CONFIG["resampling"], "cpu")


@pytest.fixture(scope="module")
def runs():
    """`RUNS` filters of one sequence by the port and by the float64
    reference, each `(lml, tv to the exact marginal)`, and the exact LML."""
    ys = _observations()
    exact_lml, marginal = ref.forward(CONFIG, ys)
    pf, rng = _filter(), torch.Generator().manual_seed(3)
    port = []
    for _ in range(RUNS):
        lml, states = pf.run(rng, ys)
        port.append((float(lml), ref.total_variation(states, marginal)))
    gen = torch.Generator().manual_seed(4)
    reference = [(lml, ref.total_variation(states, marginal))
                 for lml, states, _ in (ref.bootstrap_filter(CONFIG, gen, ys, K) for _ in range(RUNS))]
    return port, reference, exact_lml


def _se(xs) -> float:
    return statistics.stdev(xs) / math.sqrt(len(xs))


@pytest.mark.parametrize("table", ["trans", "obs"])
def test_the_reference_tables_equal_the_configuration_s_bit_for_bit(table):
    made = _hmm().transition_tensor("cpu") if table == "trans" else _hmm().observation_tensor("cpu")
    assert made.dtype == torch.float32
    assert torch.equal(ref.logits(CONFIG, table, torch.float32), made)


def test_the_reference_forward_lml_equals_exact_log_marginal():
    """The port's `exact_log_marginal` runs the forward algorithm in
    float32, the reference in float64: 1e-6 of the LML's size."""
    ys = _observations()
    lml, marginal = ref.forward(CONFIG, ys)
    port = float(exact_log_marginal(_hmm(), ys, CONFIG["initial_state"]))
    assert abs(port - lml) <= 1e-6 * abs(lml)
    assert marginal.dtype == torch.float64 and math.isclose(float(marginal.sum()), 1.0, rel_tol=1e-12)


def test_the_port_s_lml_against_the_exact_value_and_the_reference_filter(runs):
    port, reference, exact_lml = runs
    lmls, ref_lmls = [x for x, _ in port], [x for x, _ in reference]
    assert abs(statistics.mean(lmls) - exact_lml) <= 5 * _se(lmls)
    pooled = math.hypot(_se(lmls), _se(ref_lmls))
    assert abs(statistics.mean(lmls) - statistics.mean(ref_lmls)) <= 5 * pooled


def test_the_port_s_final_states_are_as_close_to_the_exact_marginal_as_the_reference_filter_s(runs):
    port, reference, _ = runs
    tvs, ref_tvs = [tv for _, tv in port], [tv for _, tv in reference]
    assert statistics.mean(tvs) <= statistics.mean(ref_tvs) + 5 * math.hypot(_se(tvs), _se(ref_tvs))


def test_the_categorical_counts_three_rows_of_64_a_particle_step():
    """One later step draws a state from its row of the transition table
    and scores it and its observation: K rows drawn, 2 K scored, 3 x 64 x K
    entries, none of them by K4 on the CPU; so does the first step, from
    the first state's row."""
    ys, rng = _observations(3), torch.Generator().manual_seed(5)
    counted = []
    for steps in (2, 3):
        before = dict(library.categorical_stats)
        _filter(256).run(rng, ys[:steps])
        counted.append({k: v - before[k] for k, v in library.categorical_stats.items()})
    one_step = {k: counted[1][k] - counted[0][k] for k in counted[0]}
    assert one_step == {"drawn": 256, "scored": 2 * 256, "entries": 3 * 64 * 256, "k4_rows": 0}
    assert counted[0] == {k: 2 * v for k, v in one_step.items()}


@pytest.mark.parametrize("threshold,fires", [(0.0, 0), (0.5, None), (1.0, 19)])
def test_hmm_filter_honours_ess_threshold(threshold, fires):
    """`hmm_filter` gates at half the particles; the `BootstrapFilter` it
    returns takes another threshold as any does: 0 never resamples (an ESS
    is never below 0), 1 resamples at every step after the first (the
    weights are never all equal)."""
    pf = _filter(512)
    assert pf.ess_threshold == 0.5
    pf = dataclasses.replace(pf, ess_threshold=threshold)
    before = particle_filter.filter_stats["resamples"]
    lml, _ = pf.run(torch.Generator().manual_seed(6), _observations(20))
    fired = particle_filter.filter_stats["resamples"] - before
    assert math.isfinite(float(lml))
    if fires is not None:
        assert fired == fires


@pytest.mark.gpu
def test_the_filter_on_k4_s_route_meets_the_exact_values():
    """At K = 65536 on the card every draw and score of the filter goes
    through K4 (`k4_rows` grows by 3 K a particle-step); the mean LML lies
    within 5 standard errors of the exact value and of the float64
    reference filter's (on the card too), and the final states are as
    close to the exact marginal as the reference filter's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    dev, k = torch.device("cuda"), 65536
    ys = _observations().to(dev)
    exact_lml, marginal = ref.forward(CONFIG, ys.cpu())
    pf = hmm_filter(_hmm(), CONFIG["initial_state"], k, CONFIG["resampling"], dev)
    rng, gen = torch.Generator(device=dev).manual_seed(3), torch.Generator(device=dev).manual_seed(4)
    port, reference = [], []
    for _ in range(RUNS):
        before = library.categorical_stats["k4_rows"]
        lml, states = pf.run(rng, ys)
        assert library.categorical_stats["k4_rows"] - before == 3 * k * T
        port.append((float(lml), ref.total_variation(states, marginal)))
        r_lml, r_states, _ = ref.bootstrap_filter(CONFIG, gen, ys, k)
        reference.append((float(r_lml), ref.total_variation(r_states, marginal)))
    lmls, ref_lmls = [x for x, _ in port], [x for x, _ in reference]
    assert abs(statistics.mean(lmls) - exact_lml) <= 5 * _se(lmls)
    assert abs(statistics.mean(lmls) - statistics.mean(ref_lmls)) <= 5 * math.hypot(_se(lmls), _se(ref_lmls))
    tvs, ref_tvs = [tv for _, tv in port], [tv for _, tv in reference]
    assert statistics.mean(tvs) <= statistics.mean(ref_tvs) + 5 * math.hypot(_se(tvs), _se(ref_tvs))
