"""K4, the categorical's draw and score over rows of logits
(`ops/categorical.py`, `csrc/categorical.cu`), and `Categorical`'s route
to it.

On the CPU: the plain twins' law (a chi-square of 2^16 draws a row on
flat, peaked and partly -inf rows), their edges (zero mass never drawn,
u -> 1 gives the last column of positive mass), the twin's score against
`Categorical.logpdf`, what the route refuses, and that importing the
package loads no K4 library. On the card (marked `gpu`, skipped without
one; run there with `python -m pytest --noconftest -m gpu
tests/test_torch_k4.py`): the kernel against its twins, slot for slot and
value for value, through `Categorical` under a `Vmap`-style batch, and the
`k4_rows` counter.
"""

import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from genjax_tpu_torch.core.typing import mark
from genjax_tpu_torch.distributions import library
from genjax_tpu_torch.distributions.library import categorical
from genjax_tpu_torch.ops import categorical as k4
from genjax_tpu_torch.ops.categorical import categorical_draw_plain, categorical_score_plain

DRAWS = 2**16
ALMOST_ONE = 1.0 - 2.0**-24  # the largest float32 below 1


def _row(kind: str, c: int, device="cpu") -> torch.Tensor:
    """A seeded row of `c` logits: all equal ("flat"); 4 x normal
    ("peaked"); or normal with every third column from the second -inf
    ("part_inf")."""
    if kind == "flat":
        return torch.zeros(c, device=device)
    x = torch.randn(c, generator=torch.Generator().manual_seed(c + len(kind))).to(device)
    if kind == "peaked":
        return 4.0 * x
    return torch.where(torch.arange(c, device=device) % 3 == 1, -torch.inf, x)


def _chi2_z(counts: torch.Tensor, p: torch.Tensor, n: int) -> float:
    """(chi2 - dof) / sqrt(2 dof) of `counts` against n * p, the bins of
    expected count under 5 pooled into one; 0 where one bin holds all."""
    expected = n * p
    small = expected < 5
    obs = torch.cat([counts[~small], counts[small].sum(0, keepdim=True)])
    exp = torch.cat([expected[~small], expected[small].sum(0, keepdim=True)])
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    dof = obs.numel() - 1
    if dof == 0:
        return 0.0
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return (chi2 - dof) / math.sqrt(2 * dof)


@pytest.mark.parametrize("c", [2, 3, 64, 1000])
@pytest.mark.parametrize("kind", ["flat", "peaked", "part_inf"])
def test_the_plain_draw_has_the_categorical_law(kind, c):
    row = _row(kind, c)
    gen = torch.Generator().manual_seed(1000 * c + len(kind))
    counts = torch.zeros(c, dtype=torch.float64)
    for _ in range(DRAWS // 4096):
        u = torch.rand(4096, generator=gen)
        v = categorical_draw_plain(row.expand(4096, c), u)
        counts += torch.bincount(v, minlength=c).double()
    p = torch.softmax(row.double(), -1)
    assert counts.sum() == DRAWS
    assert counts[p == 0].sum() == 0, "a column of zero mass was drawn"
    assert _chi2_z(counts, p, DRAWS) < 5.0


def test_the_plain_draw_s_edges():
    x = torch.randn(64, generator=torch.Generator().manual_seed(7))
    x[:5] = -torch.inf  # no mass before column 5
    x[50:] = -torch.inf  # none after column 49
    x[20:30] = -torch.inf
    rows = x.expand(4, 64)
    u = torch.tensor([0.0, ALMOST_ONE, 1.0, 0.5])
    v = categorical_draw_plain(rows, u)
    assert v[:3].tolist() == [5, 49, 49]
    assert not (20 <= int(v[3]) < 30)
    dead = torch.full((2, 8), -torch.inf)
    assert categorical_draw_plain(dead, torch.tensor([0.0, 0.9])).tolist() == [0, 0]
    # Every u draws a column of positive mass, on the boundaries too.
    grid = torch.linspace(0.0, ALMOST_ONE, 4097)
    drawn = categorical_draw_plain(x.expand(4097, 64), grid)
    assert torch.isfinite(x[drawn]).all()
    assert bool((drawn[1:] >= drawn[:-1]).all()), "inverse CDF: the value grows with u"


@pytest.mark.parametrize("c", [2, 64, 1000])
def test_the_plain_score_equals_categorical_logpdf(c):
    g = torch.Generator().manual_seed(c)
    rows = 3.0 * torch.randn(256, c, generator=g)
    rows[::7, ::3] = -torch.inf
    values = torch.randint(-2, c + 2, (256,), generator=g)
    half = torch.arange(256) % 4 == 0
    # Whole-number floats score as their integer, others outside the support.
    for v, ints in ((values, values), (values.double(), values), (values.float() + 0.5 * half, values.where(~half, -1))):
        ref = categorical.logpdf(v, logits=rows)
        got = categorical_score_plain(rows, ints)
        assert got.dtype == ref.dtype == torch.float32
        inf = torch.isinf(ref)
        assert torch.equal(torch.isinf(got), inf) and bool((got[inf] == ref[inf]).all())
        assert bool(((got - ref).abs()[~inf] <= 1e-6 * ref.abs()[~inf].clamp(min=1.0)).all())


def _stand_in(**kw):
    """What `takes` reads of a tensor: a CUDA float32 (8, 64) tensor with a
    contiguous last axis and no gradient, but for `kw`."""
    facts = {"is_cuda": True, "dtype": torch.float32, "shape": (8, 64), "strides": (64, 1), "requires_grad": False}
    facts.update(kw)
    return SimpleNamespace(**facts, stride=lambda d: facts["strides"][d])


@pytest.mark.parametrize(
    "facts, taken",
    [
        ({}, True),
        ({"shape": (8, 64)}, True),
        ({"shape": (64,), "strides": (1,)}, True),
        ({"is_cuda": False}, False),
        ({"dtype": torch.float64}, False),
        ({"dtype": torch.bfloat16}, False),
        ({"shape": (8, 1)}, False),
        ({"shape": (8, 65)}, False),
        ({"strides": (1, 8)}, False),
        ({"requires_grad": True}, False),
    ],
    ids=["cuda_f32", "widest", "one_row", "cpu", "float64", "bfloat16", "one_category", "too_wide",
         "strided_last_axis", "records_grad"],
)
def test_takes_refuses_what_the_kernel_does_not_take(facts, taken):
    assert k4.takes(_stand_in(**facts)) is taken


def test_takes_allows_logits_that_require_grad_where_none_is_recorded():
    with torch.no_grad():
        assert k4.takes(_stand_in(requires_grad=True))


def test_the_route_takes_rows_of_every_shape(monkeypatch):
    # With `takes` holding on the CPU and the kernel's wrappers replaced by
    # the twins, the route's own choices show: single rows, shared rows and
    # batches of rows all go to K4, as (rows, C) with the broadcast strides.
    calls = []

    def draw(rows, u):
        calls.append(("draw", tuple(rows.shape), rows.stride(0)))
        return categorical_draw_plain(rows, u)

    def score(rows, values):
        calls.append(("score", tuple(rows.shape), rows.stride(0), values.stride(0)))
        return categorical_score_plain(rows, values)

    monkeypatch.setattr(k4, "takes", lambda logits: True)
    monkeypatch.setattr(k4, "k4_draw", draw)
    monkeypatch.setattr(k4, "k4_score", score)
    rng, row = torch.Generator().manual_seed(0), torch.randn(5)
    before = library.categorical_stats["k4_rows"]
    assert categorical.sample(rng, logits=row).shape == ()
    assert categorical.logpdf(torch.tensor(2), logits=row).shape == ()
    assert categorical.sample(rng, logits=row, n=8).shape == (8,)
    assert categorical.logpdf(torch.arange(5), logits=row).shape == (5,)
    assert categorical.logpdf(torch.tensor(3), logits=torch.randn(6, 5)).shape == (6,)
    assert categorical.sample(rng, logits=mark(torch.randn(4, 1, 5), 2), n=(4, 3)).shape == (4, 3)
    assert categorical.logpdf(torch.tensor([[1], [2]]), logits=torch.randn(3, 5)).shape == (2, 3)
    assert categorical.logpdf(torch.tensor(1.0), logits=row).shape == ()
    assert calls == [("draw", (1, 5), 5), ("score", (1, 5), 5, 1), ("draw", (8, 5), 0), ("score", (5, 5), 0, 1),
                     ("score", (6, 5), 5, 0), ("draw", (12, 5), 5), ("score", (6, 5), 5, 1), ("score", (1, 5), 5, 1)]
    assert library.categorical_stats["k4_rows"] - before == 1 + 1 + 8 + 5 + 6 + 12 + 6 + 1
    with pytest.raises(RuntimeError, match="do not broadcast"):
        categorical.logpdf(torch.zeros(4, dtype=torch.int64), logits=torch.randn(3, 5))


def test_on_the_cpu_the_route_is_never_taken():
    before = dict(library.categorical_stats)
    rng = torch.Generator().manual_seed(1)
    v = categorical.sample(rng, logits=torch.randn(64), n=128)
    categorical.logpdf(v, logits=torch.randn(128, 64))
    assert library.categorical_stats["k4_rows"] == before["k4_rows"]
    assert library.categorical_stats["drawn"] - before["drawn"] == 128
    assert library.categorical_stats["scored"] - before["scored"] == 128


def test_importing_the_package_loads_no_k4_library():
    code = (
        "import torch\n"
        "import genjax_tpu_torch as gx\n"
        "from genjax_tpu_torch.ops import _build, categorical as k4\n"
        "from genjax_tpu_torch.distributions.library import categorical\n"
        "v = categorical.sample(torch.Generator().manual_seed(0), logits=torch.zeros(64), n=16)\n"
        "lp = categorical.logpdf(v, logits=torch.zeros(16, 64))\n"
        "print(_build.load_library.cache_info().currsize, k4._library.cache_info().currsize, "
        "k4.k4_draw.launches, k4.k4_score.launches, v.shape[0], round(float(lp.sum()), 3))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={"PATH": "", "CUDA_VISIBLE_DEVICES": ""},
        cwd=Path(__file__).resolve().parent.parent,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0", "0", "0", "16", str(round(16 * -math.log(64), 3))]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    return torch.device("cuda")


def _rows(k: int, c: int, dev, seed: int) -> torch.Tensor:
    """(k, c) seeded logits, 3 x normal, every 5th row with columns -inf in
    runs that cross the lanes' boundaries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 3.0 * torch.randn(k, c, generator=g, device=dev)
    dead = (torch.arange(c, device=dev) // 7) % 3 == 1
    x[::5] = torch.where(dead, -torch.inf, x[::5])
    return x


def _twin_draw(rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The twin in pieces of 2^18 rows (its float64 prefix sums are large)."""
    return torch.cat([categorical_draw_plain(rows[i : i + 2**18], u[i : i + 2**18]) for i in range(0, len(u), 2**18)])


def _assert_scores_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    special = ~torch.isfinite(ref)
    assert torch.equal(special, ~torch.isfinite(got))
    assert torch.equal(got[special].nan_to_num(nan=1.0), ref[special].nan_to_num(nan=1.0))
    err = (got - ref).abs()[~special] / ref.abs()[~special].clamp(min=1.0)
    assert err.numel() == 0 or float(err.max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 3, 33, 64])
@pytest.mark.parametrize("k", [4096, 2**20])
def test_k4_draw_equals_its_twin_slot_for_slot(cuda, k, c):
    # The same uniforms; a slot may differ only where u * total lies within
    # the float64 rounding of a prefix sum (none expected).
    rows = _rows(k, c, cuda, seed=k + c)
    u = torch.rand(k, generator=torch.Generator(device=cuda).manual_seed(c), device=cuda)
    u[:4] = torch.tensor([0.0, ALMOST_ONE, 0.5, 1e-30], device=cuda)
    for given in (rows, rows[3].expand(k, c), rows[:, : c - 1] if c > 3 else rows):
        got = k4.k4_draw(given, u)
        torch.cuda.synchronize()
        ref = _twin_draw(given, u)
        assert got.dtype == torch.int64 and got.shape == (k,)
        assert bool(torch.isfinite(given.gather(1, got[:, None])).all()), "K4 drew a column of zero mass"
        assert int((got != ref).sum()) <= 1e-4 * k


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 33, 64])
def test_k4_score_equals_the_plain_score(cuda, c):
    k = 65536
    rows = _rows(k, c, cuda, seed=c)
    rows[7] = -torch.inf  # all -inf: NaN where in the support, as torch.logsumexp gives
    g = torch.Generator(device=cuda).manual_seed(c + 1)
    values = torch.randint(-2, c + 2, (k,), generator=g, device=cuda)
    shared_row, shared_value = rows[11].expand(k, c), torch.tensor(c // 2, device=cuda).expand(k)
    for given, v in ((rows, values), (shared_row, values), (rows, shared_value), (shared_row, shared_value)):
        got = k4.k4_score(given, v)
        _assert_scores_close(got, categorical_score_plain(given, v))
        _assert_scores_close(got, categorical.logpdf(v.cpu(), logits=given.cpu()).to(cuda))
    # Through `Categorical`, float values take the eager conversion, then K4.
    for v in (values.float() + 0.5 * (torch.arange(k, device=cuda) % 4 == 0), values.double()):
        before = k4.k4_score.launches
        got = categorical.logpdf(v, logits=rows)
        assert k4.k4_score.launches - before == 1
        _assert_scores_close(got, categorical.logpdf(v.cpu(), logits=rows.cpu()).to(cuda))


@pytest.mark.gpu
def test_k4_draws_under_a_vmap_style_batch(cuda):
    k, n, c = 4096, 8, 64
    logits = mark(_rows(k, c, cuda, seed=3).unsqueeze(1), 2)  # (K, 1, C): the same in every lane
    rng = torch.Generator(device=cuda).manual_seed(9)
    replay = torch.Generator(device=cuda).manual_seed(9)
    before = (library.categorical_stats["k4_rows"], k4.k4_draw.launches)
    got = categorical.sample(rng, logits=logits, n=(k, n))
    assert got.shape == (k, n)
    assert (library.categorical_stats["k4_rows"] - before[0], k4.k4_draw.launches - before[1]) == (k * n, 1)
    rows = logits.as_subclass(torch.Tensor).expand(k, n, c).reshape(-1, c)
    ref = _twin_draw(rows, torch.rand(k * n, generator=replay, device=cuda)).view(k, n)
    assert int((got != ref).sum()) <= 1e-4 * k * n
    # Each lane is its own draw from the particle's row.
    assert bool((got != got[:, :1]).any())


@pytest.mark.gpu
def test_k4_rows_counts_what_k4_drew_and_scored(cuda):
    k, c = 1024, 64
    stats = library.categorical_stats
    rng = torch.Generator(device=cuda).manual_seed(0)
    logits = _rows(k, c, cuda, seed=5)

    def counted(fn) -> dict:
        before = dict(stats)
        fn()
        return {key: stats[key] - before[key] for key in stats}

    assert counted(lambda: categorical.sample(rng, logits=logits[0], n=k)) == {
        "drawn": k, "scored": 0, "entries": k * c, "k4_rows": k}
    assert counted(lambda: categorical.logpdf(torch.tensor(3, device=cuda), logits=logits)) == {
        "drawn": 0, "scored": k, "entries": k * c, "k4_rows": k}
    assert counted(lambda: categorical.random_weighted(rng, logits, n=None))["k4_rows"] == 2 * k
    assert counted(lambda: categorical.sample(rng, logits=logits[0]))["k4_rows"] == 1  # one row
    assert counted(lambda: categorical.logpdf(torch.tensor(2, device=cuda), logits=logits[0]))["k4_rows"] == 1
    assert counted(lambda: categorical.logpdf(torch.arange(k, device=cuda), logits=logits.double()))["k4_rows"] == 0
    for wide in (torch.zeros(k, 65, device=cuda), torch.zeros(k, 2000, device=cuda)):
        assert counted(lambda: categorical.sample(rng, logits=wide))["k4_rows"] == 0
    needs_grad = logits.clone().requires_grad_()
    assert counted(lambda: categorical.logpdf(torch.arange(k, device=cuda) % c, logits=needs_grad))["k4_rows"] == 0
    with torch.no_grad():
        assert counted(lambda: categorical.logpdf(torch.tensor(1, device=cuda), logits=needs_grad))["k4_rows"] == k
