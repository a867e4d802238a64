"""NUTS (`inference/requests/nuts.py`) in the port, statistically, after
`tests/inference/test_nuts.py` at the port's CPU sizes (C <= 4096 chains
for the invariance check, max_depth <= 5): exact posterior starts stay
exact; chains reach the conjugate and correlated posteriors; a tiny step
reaches the maximum depth, a huge one diverges and keeps the state, a
U-turn stops early; the weight is 0; warmup adapts the step and the mass;
`run_nuts_chains` agrees with long HMC chains. Bounds at 6 standard
errors, as there (5 combined SE against HMC). The deterministic parity
with JAX is in `test_torch_nuts.py`.
"""

import numpy as np
import torch

import genjax_tpu_torch as tgx
from genjax_tpu_torch.inference.requests import nuts as tnuts
from genjax_tpu_torch.models.logreg import run_hmc_chains, run_nuts_chains, simulate_logreg_data

torch.set_num_threads(1)


@tgx.gen
def chain_model():
    mu1 = tgx.normal(0.0, 1.0) @ "mu1"
    mu2 = tgx.normal(mu1, 1.0) @ "mu2"
    _ = tgx.normal(mu2, 1.0) @ "y"


@tgx.gen
def conjugate():
    mu = tgx.normal(0.0, 1.0) @ "mu"
    _ = tgx.normal(mu, 1.0) @ "y"


POST_MEAN, POST_VAR = 0.5, 0.5


def _conjugate_batch(rng, n, **obs):
    return conjugate.importance(rng, tgx.ChoiceMap.kw(y=1.0, **obs), (), n=n)[0]


def test_exact_posterior_start_stays_exact():
    n = 4096
    rng = torch.Generator().manual_seed(0)
    mus = POST_MEAN + np.sqrt(POST_VAR) * torch.randn(n, generator=rng)
    traces = _conjugate_batch(rng, n, mu=tgx.per_particle(mus))
    traces, _ = tgx.run_chains(rng, traces, tgx.NUTS(tgx.Selection.at["mu"], 0.4, max_depth=4), 3)
    out = traces.get_choices()["mu"].double()
    assert abs(float(out.mean()) - POST_MEAN) < 6 * np.sqrt(POST_VAR / n)
    assert abs(float(out.var(correction=0)) - POST_VAR) < 6 * np.sqrt(2 * POST_VAR**2 / (n - 1))
    cm3 = float(((out - out.mean()) ** 3).mean())
    assert abs(cm3) < 6 * np.sqrt(6 * POST_VAR**3 / n)


def test_conjugate_chains():
    rng = torch.Generator().manual_seed(2)
    n, steps = 64, 60
    traces = _conjugate_batch(rng, n)
    _, mus = tgx.run_chains(
        rng, traces, tgx.NUTS(tgx.Selection.at["mu"], 0.5, max_depth=4), steps,
        collect=lambda t: t.get_choices()["mu"],
    )
    mus = mus[:, 10:].double()
    se = np.sqrt(POST_VAR / (mus.numel() / 10))
    assert abs(float(mus.mean()) - POST_MEAN) < 6 * se
    assert abs(float(mus.var()) - POST_VAR) < 0.1


def test_correlated_gaussian_exact_cov():
    rng = torch.Generator().manual_seed(3)
    traces, _ = chain_model.importance(rng, tgx.ChoiceMap.kw(y=2.0), (), n=64)
    sel = tgx.Selection.at["mu1"] | tgx.Selection.at["mu2"]
    _, out = tgx.run_chains(
        rng, traces, tgx.NUTS(sel, 0.4, max_depth=5), 80,
        collect=lambda t: torch.stack([t.get_choices()["mu1"], t.get_choices()["mu2"]], -1),
    )
    m = out[:, 15:].reshape(-1, 2).double()
    n_eff = m.shape[0] / 10
    assert abs(float(m[:, 0].mean()) - 2 / 3) < 6 * np.sqrt((2 / 3) / n_eff)
    assert abs(float(m[:, 1].mean()) - 4 / 3) < 6 * np.sqrt((2 / 3) / n_eff)
    assert abs(float(m[:, 0].var()) - 2 / 3) < 0.12
    assert abs(float(m[:, 1].var()) - 2 / 3) < 0.12
    cov = float(((m[:, 0] - m[:, 0].mean()) * (m[:, 1] - m[:, 1].mean())).mean())
    assert abs(cov - 1 / 3) < 0.12


def test_tiny_eps_reaches_max_depth():
    rng = torch.Generator().manual_seed(0)
    tr, _ = conjugate.importance(rng, tgx.ChoiceMap.kw(y=1.0, mu=0.5), ())
    _, info = tnuts.nuts_kernel(torch.Generator().manual_seed(1), tr, tgx.Selection.at["mu"], 0.01, max_depth=4)
    assert int(info.depth) == 4
    assert not bool(info.diverged)
    assert 0.98 < float(info.accept_stat) <= 1.0


def test_huge_eps_diverges_and_keeps_state():
    rng = torch.Generator().manual_seed(0)
    tr = _conjugate_batch(rng, 8)
    new_tr, info = tnuts.nuts_kernel(rng, tr, tgx.Selection.at["mu"], 1e4, max_depth=4)
    assert bool(info.diverged.all())
    # The first leaf diverged, so nothing merged: the draw is the start.
    assert torch.equal(new_tr.get_choices()["mu"], tr.get_choices()["mu"])
    assert bool((info.depth == 0).all())


def test_uturn_terminates_early():
    rng = torch.Generator().manual_seed(0)
    tr, _ = conjugate.importance(rng, tgx.ChoiceMap.kw(y=1.0), ())
    batch = _conjugate_batch(rng, 16, mu=tgx.per_particle(tr.get_choices()["mu"].expand(16).clone()))
    _, info = tnuts.nuts_kernel(rng, batch, tgx.Selection.at["mu"], 0.6, max_depth=8)
    assert int(info.depth.max()) <= 5, info.depth
    assert int(info.depth.min()) >= 1, info.depth


def test_observed_site_untouched_and_weight_zero():
    rng = torch.Generator().manual_seed(0)
    tr = _conjugate_batch(rng, 4)
    req = tgx.NUTS(tgx.Selection.at["mu"], 0.3, max_depth=4)
    new_tr, w, _, bwd = req.edit(rng, tr, tgx.Diff.no_change(()))
    assert torch.equal(w, torch.zeros(4))
    assert float(new_tr.get_choices()["y"]) == 1.0
    assert isinstance(bwd, tgx.NUTS)


def test_warmup_adapts_scale_and_mass():
    @tgx.gen
    def scaled():
        a = tgx.normal(0.0, 10.0) @ "a"
        b = tgx.normal(0.0, 0.1) @ "b"
        _ = tgx.normal(a + b, 5.0) @ "y"

    rng = torch.Generator().manual_seed(0)
    traces, _ = scaled.importance(rng, tgx.ChoiceMap.kw(y=1.0), (), n=64)
    _, res = tnuts.nuts_warmup(rng, traces, tgx.Selection.at["a"] | tgx.Selection.at["b"], n_steps=60, max_depth=4)
    assert float(res.eps) > 0
    ratio = float(res.inv_mass["a"]) / float(res.inv_mass["b"])
    assert ratio > 100, ratio  # posterior variances about 80 and 0.01
    assert 0.5 < float(res.accept_rate) <= 1.0


def test_sampling_with_warmed_kernel():
    rng = torch.Generator().manual_seed(1)
    n = 64
    traces = _conjugate_batch(rng, n)
    warmed, res = tnuts.nuts_warmup(rng, traces, tgx.Selection.at["mu"], n_steps=45, max_depth=4)
    final, _ = tgx.run_chains(rng, warmed, tgx.NUTS(tgx.Selection.at["mu"], res.eps, 4, res.inv_mass), 30)
    out = final.get_choices()["mu"].double()
    assert abs(float(out.mean()) - POST_MEAN) < 6 * np.sqrt(POST_VAR / n)


def test_run_nuts_chains_logreg_against_hmc():
    """`run_nuts_chains` at a small width: the final `w` agrees with long
    HMC chains' within 5 combined SE, every proposal is accepted."""
    X, ys, _ = simulate_logreg_data(torch.Generator().manual_seed(3), 64, 3)
    w, accs = run_nuts_chains(torch.Generator().manual_seed(4), X, ys, n_chains=256, n_steps=8, eps=0.1, max_depth=4)
    assert w.shape == (256, 3) and accs.shape == (256, 8) and bool(accs.all())
    w_hmc, _ = run_hmc_chains(
        torch.Generator().manual_seed(5), X, ys, n_chains=256, n_steps=40, eps=0.1, L=8
    )
    se = (w.var(0) / 256 + w_hmc.var(0) / 256).sqrt()
    assert bool(((w.mean(0) - w_hmc.mean(0)).abs() < 5 * se).all()), (w.mean(0), w_hmc.mean(0), se)
