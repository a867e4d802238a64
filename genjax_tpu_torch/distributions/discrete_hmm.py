"""Exact-posterior discrete HMM: forward filtering backward sampling
(FFBS), exact data marginals, and the `DiscreteHMM` distribution over
latent paths.

Counterpart of `genjax_tpu/distributions/discrete_hmm.py`. The time loops
are Python loops over `T` steps with `torch.logsumexp` over the state
axis; the backward pass draws any number of paths at once (a leading
path axis).
"""

import math
from typing import Any

import torch

from genjax_tpu_torch.core.concepts import Score
from genjax_tpu_torch.core.pytree import Pytree
from genjax_tpu_torch.distributions.distribution import Distribution


def _circulant(source: torch.Tensor) -> torch.Tensor:
    """The circulant matrix whose first column is `source`."""
    n = source.shape[0]
    index = torch.arange(n, device=source.device)
    return source[(index[:, None] - index[None, :]) % n]


def scaled_circulant(N: int, k: int, epsilon: float, delta: float, device="cuda") -> torch.Tensor:
    """Banded circulant logit tensor: entries within distance `k` of the
    diagonal get `epsilon^|distance|`, the rest `-delta`. Made on the card
    unless the caller passes `device="cpu"`."""
    index = torch.arange(N, device=device)
    eps = torch.tensor(float(epsilon), device=device)
    near = torch.pow(eps, index.abs().to(torch.float32))
    wrapped = torch.pow(eps, (index - N).abs().to(torch.float32))
    vals = torch.where(index <= k, near, torch.where(index - N >= -k, wrapped, -float(delta)))
    return _circulant(vals)


@Pytree.dataclass
class DiscreteHMMConfiguration(Pytree):
    """Grid-structured HMM with banded-circulant transition and
    observation logits (the exact-inference testbed family). The tables
    are made on the card unless the caller passes `device="cpu"`, as
    every entry point of the package is; the functions below that are
    given observations or a generator make them where those live."""

    linear_grid_dim: int = Pytree.static()
    adjacency_distance_trans: int = Pytree.static()
    adjacency_distance_obs: int = Pytree.static()
    sigma_trans: float = Pytree.static()
    sigma_obs: float = Pytree.static()

    def _tensor(self, distance: int, sigma: float, device) -> torch.Tensor:
        if sigma > 0.0:
            return scaled_circulant(self.linear_grid_dim, distance, sigma, 1.0 / sigma, device)
        return scaled_circulant(self.linear_grid_dim, distance, -math.inf, math.inf, device)

    def transition_tensor(self, device="cuda") -> torch.Tensor:
        return self._tensor(self.adjacency_distance_trans, self.sigma_trans, device)

    def observation_tensor(self, device="cuda") -> torch.Tensor:
        return self._tensor(self.adjacency_distance_obs, self.sigma_obs, device)

    def prior_logits(self, device="cuda") -> torch.Tensor:
        init = self.linear_grid_dim // 2
        return torch.log_softmax(self.transition_tensor(device)[init, :], dim=-1)

    def transition_log_probs(self, device="cuda") -> torch.Tensor:
        return torch.log_softmax(self.transition_tensor(device), dim=-1)

    def observation_log_probs(self, device="cuda") -> torch.Tensor:
        return torch.log_softmax(self.observation_tensor(device), dim=-1)

    def tables(self, device="cuda") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(prior, transition, observation) log probabilities."""
        return self.prior_logits(device), self.transition_log_probs(device), self.observation_log_probs(device)


def forward_filter(prior: torch.Tensor, trans: torch.Tensor, obs: torch.Tensor, observations: torch.Tensor):
    """Forward algorithm: the per-step filtering distributions
    `p(z_t | x_{1:t})` (log space, `(T, N)`) and the exact log data
    marginal.

    `prior`: [N] log p(z_0); `trans`: [N, N] log p(z_t | z_{t-1}) with
    rows indexed by z_{t-1}; `obs`: [N, M] log p(x | z)."""
    log_alpha = prior
    filters, total = [], None
    for t in range(observations.shape[0]):
        # predict: p(z_t | x_{1:t-1})
        pred = log_alpha if t == 0 else torch.logsumexp(log_alpha[:, None] + trans, dim=0)
        post = pred + obs.index_select(1, observations[t].reshape(1)).squeeze(1)
        log_evidence = torch.logsumexp(post, dim=0)
        log_alpha = post - log_evidence
        filters.append(log_alpha)
        total = log_evidence if total is None else total + log_evidence
    return torch.stack(filters), total


def _draw_states(rng: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of `logits` (Gumbel-argmax)."""
    e = torch.empty(logits.shape, device=rng.device).exponential_(generator=rng)
    return torch.argmax(logits - torch.log(e), dim=-1)


def backward_sample(rng: torch.Generator, trans: torch.Tensor, filters: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Backward pass of FFBS: `z_T` from the last filter, then
    `z_t ~ p(z_t | x_{1:t}, z_{t+1})` backwards. One path `(T,)`, or with
    `n` that many independent paths `(n, T)`."""
    T = filters.shape[0]
    lead = () if n is None else (n,)
    z = _draw_states(rng, filters[T - 1].expand(*lead, -1))
    path = [z]
    for t in range(T - 2, -1, -1):
        # trans[:, z]: one column per path
        logits = filters[t] + trans.index_select(1, z.reshape(-1)).T.reshape(*lead, -1)
        z = _draw_states(rng, logits)
        path.append(z)
    return torch.stack(path[::-1], dim=-1)


def forward_filtering_backward_sampling(
    rng: torch.Generator, config: DiscreteHMMConfiguration, observation_sequence: torch.Tensor, n: int | None = None
):
    """Exact posterior latent paths of the configured HMM: returns
    (samples, filters)."""
    prior, trans, obs = config.tables(rng.device)
    filters, _ = forward_filter(prior, trans, obs, observation_sequence)
    return backward_sample(rng, trans, filters, n), filters


def path_joint_logpdf(
    prior: torch.Tensor, trans: torch.Tensor, obs: torch.Tensor, latents: torch.Tensor, observations: torch.Tensor
) -> Score:
    """log p(z_{1:T}, x_{1:T}) for latent paths `(..., T)`."""
    init_term = prior[latents[..., 0]]
    trans_terms = trans[latents[..., :-1], latents[..., 1:]]
    obs_terms = obs[latents, observations]
    return init_term + trans_terms.sum(-1) + obs_terms.sum(-1)


@Pytree.dataclass
class _DiscreteHMM(Distribution[Any]):
    """Distribution over the latent paths of a discrete HMM given its
    observations, with exact posterior sampling (FFBS) and exact posterior
    density: the ground truth that approximate inference is held against.
    Its parameters are `(config, observations)`; with `n` it draws `n`
    paths `(n, T)`."""

    def data_logpdf(self, config: DiscreteHMMConfiguration, observations: torch.Tensor) -> Score:
        """Exact log marginal p(x_{1:T}) by the forward algorithm."""
        return forward_filter(*config.tables(observations.device), observations)[1]

    def random_weighted(self, rng, config: DiscreteHMMConfiguration, observations: torch.Tensor, n=None):
        prior, trans, obs = config.tables(observations.device)
        filters, log_marginal = forward_filter(prior, trans, obs, observations)
        latents = backward_sample(rng, trans, filters, n)
        return path_joint_logpdf(prior, trans, obs, latents, observations) - log_marginal, latents

    def estimate_logpdf(self, rng, v: torch.Tensor, config: DiscreteHMMConfiguration, observations: torch.Tensor) -> Score:
        """Exact posterior density log p(z | x) = log p(z, x) - log p(x)."""
        prior, trans, obs = config.tables(observations.device)
        _, log_marginal = forward_filter(prior, trans, obs, observations)
        return path_joint_logpdf(prior, trans, obs, v, observations) - log_marginal


DiscreteHMM = _DiscreteHMM()
