"""Port parity: the row-wise kth-largest distinct value against the JAX package.

``rowwise_kth_value_plain`` (the CUDA kernel's plain version) is held against
the JAX Pallas kernel in interpret mode and against the JAX package's XLA
chain of max and suppress passes, on the same seeded numpy rows. The function
selects one of its inputs and rounds nothing, so the comparison is exact.
Cases: ties inside the top k (which is where it differs from a sort-based
kth value), ties outside it, N no multiple of 128 (the TPU's lane width) or
of 4, rows with fewer than k distinct values (-1e30), rows of the assigner's
kind (mostly zeros, no negatives). The assigner's top-k membership, which
takes its threshold from the same chain, is held against the JAX one. The
CUDA kernel's two-level algorithm (``two_level_kth``: parts of a row, each
keeping its k largest distinct values under a running threshold, merged by
the suppress chain) is held to both, exactly. The kernel on the card is
checked in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xlstm_yolo_tpu.kernels.topk_pallas import NEG_INF as JAX_NEG_INF
from xlstm_yolo_tpu.kernels.topk_pallas import rowwise_kth_value as jax_kth
from xlstm_yolo_tpu.utils.tal import topk_positive_mask as jax_topk_mask
from xlstm_yolo_torch.kernels.topk import NEG_INF, rowwise_kth_value, rowwise_kth_value_plain
from xlstm_yolo_torch.utils.tal import topk_positive_mask


def rows(R, N, seed, k):
    """Seeded rows: normal draws on odd rows; on even rows mostly zeros and
    no negatives, as the assigner's masked metric. Rows 0 and 1 tie their
    four largest values and their 6th with their 7th (ties inside the top
    k); row 2 ties values far below it; the last row holds at most four
    distinct values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, N)).astype(np.float32)
    x[::2] = np.where(rng.random((len(x[::2]), N)) < 0.9, 0.0, np.abs(x[::2]))
    order = np.argsort(-x, axis=1)
    for r in range(min(2, R)):
        x[r, order[r, 1:4]] = x[r, order[r, 0]]
        if N > 6:
            x[r, order[r, 6]] = x[r, order[r, 5]]
    if R > 2 and N > 3 * k:
        x[2, order[2, -5:]] = x[2, order[2, -6]]
    x[-1] = rng.integers(0, 4, N).astype(np.float32)
    return x


def distinct_kth(x, k):
    """The definition, by numpy: the kth largest distinct value of each row."""
    out = []
    for row in x:
        u = np.unique(row)[::-1]
        out.append(u[k - 1] if len(u) >= k else np.float32(NEG_INF))
    return np.asarray(out, np.float32)[:, None]


CASES = [(7, 300, 10), (16, 131, 3), (4, 8400, 10), (5, 50, 1), (6, 33, 16), (3, 7, 10)]


@pytest.mark.parametrize("R,N,k", CASES)
def test_kth_value_plain_matches_jax_kernel_interpret(R, N, k):
    x = rows(R, N, seed=R + N, k=k)
    want = np.asarray(jax_kth(jnp.asarray(x), k, interpret=True))
    got = rowwise_kth_value_plain(torch.from_numpy(x), k).numpy()
    assert got.shape == (R, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R,N,k", CASES)
def test_kth_value_plain_matches_jax_xla_chain_and_the_definition(R, N, k):
    x = rows(R, N, seed=R + N + 1, k=k)
    got = rowwise_kth_value_plain(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_kth(jnp.asarray(x), k)))
    np.testing.assert_array_equal(got, distinct_kth(x, k))


def test_kth_value_differs_from_a_sort_where_values_tie():
    """Equal values fall together: with the four largest tied, the 2nd
    distinct value is the 5th of a sort; fewer than k distinct values give
    -1e30, the JAX package's sentinel."""
    assert NEG_INF == JAX_NEG_INF
    x = torch.tensor([[5.0, 5.0, 5.0, 5.0, 3.0, 2.0, 1.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    got = rowwise_kth_value_plain(x, 2)
    assert got[0, 0] == 3.0 and torch.topk(x, 2).values[0, -1] == 5.0
    assert got[1, 0] == np.float32(NEG_INF)
    assert rowwise_kth_value_plain(x, 1)[1, 0] == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kth_value_casts_half_types_to_fp32_as_jax(dtype):
    x = torch.from_numpy(rows(6, 200, seed=2, k=5)).to(dtype)
    got = rowwise_kth_value(x, 5)
    assert got.dtype == torch.float32
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = jax_kth(jnp.asarray(x.float().numpy()).astype(jdt), 5, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kth_value_on_cpu_is_the_plain_version_and_refuses():
    x = torch.from_numpy(rows(5, 70, seed=3, k=4))
    before = rowwise_kth_value.launches
    got = rowwise_kth_value(x, 4)
    assert rowwise_kth_value.launches == before  # no kernel launched for CPU tensors
    assert torch.equal(got, rowwise_kth_value_plain(x, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        rowwise_kth_value(x.to("meta"), 4)
    with pytest.raises(ValueError, match="k must be"):
        rowwise_kth_value(x, 0)
    with pytest.raises(ValueError, match=r"\(R, N\)"):
        rowwise_kth_value(x[0], 4)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_topk_positive_mask_matches_jax_with_ties(k):
    """The assigner's membership on (B, n_max, n_anchors) metrics with ties
    at and inside the top k, an all-zero row (no member) and a row of equal
    positive values (the kth value falls to -1e30, the threshold to 0: every
    entry is a member)."""
    x = np.abs(rows(12, 400, seed=4, k=k)).reshape(2, 6, 400)
    x[0, 3] = 0.0
    x[1, 4] = 0.25
    got = topk_positive_mask(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_topk_mask(jnp.asarray(x), k)))
    assert got[0, 3].sum() == 0 and got[1, 4].sum() == 400


def two_level_kth(x, k, parts):
    """The CUDA kernel's algorithm in numpy, for x (R, N) -> (R, 1). Each of
    ``parts`` parts of a row (a thread's share) keeps its k largest distinct
    values, sorted, with the kth as a running threshold (-1e30 until it has
    k): a value at or below it is dropped by one comparison, a survivor goes
    in unless it is there already. The parts' lists are then merged by the
    suppress chain: round i takes the largest listed value below round
    i-1's. Returns the result and, per row, how many parts had no survivor."""
    out, idle = [], []
    for row in x.astype(np.float32):
        lists, quiet = [], 0
        for part in np.array_split(row, parts):
            lst, thr = [], np.float32(NEG_INF)
            for v in part:
                if v > thr and v not in lst:
                    lst = sorted(lst + [v], reverse=True)[:k]
                    thr = lst[-1] if len(lst) == k else thr
            lists += lst
            quiet += not lst
        cand, prev = np.asarray(lists, np.float32), np.float32(np.inf)
        for _ in range(k):
            below = cand[cand < prev]
            prev = below.max() if len(below) else np.float32(NEG_INF)
        out.append(prev)
        idle.append(quiet)
    return np.asarray(out, np.float32)[:, None], idle


@pytest.mark.parametrize("R,N,k,parts", [(7, 300, 10, 4), (5, 130, 1, 3), (6, 257, 16, 8),
                                         (4, 96, 16, 3)])
def test_two_level_kth_matches_jax_kernel_and_chain(R, N, k, parts):
    """Exact equality with the interpret-mode JAX kernel and the plain chain:
    ties inside the top k and across the parts' boundaries (row 1's largest
    value starts every part, row 3 ties the values on both sides of every
    boundary), a part with no survivors (row 0's last part all -1e30), rows
    of the assigner's kind, and a row with fewer than k distinct values."""
    x = rows(R, N, seed=R + N + k, k=k)
    starts = np.cumsum([0] + [len(p) for p in np.array_split(np.arange(N), parts)])[:-1]
    x[1, starts] = x[1].max()
    x[3, starts[1:] - 1] = x[3, starts[1:]] = np.float32(0.75)
    x[0, starts[-1]:] = np.float32(NEG_INF)
    got, idle = two_level_kth(x, k, parts)
    assert got.shape == (R, 1) and idle[0] >= 1
    np.testing.assert_array_equal(got, np.asarray(jax_kth(jnp.asarray(x), k, interpret=True)))
    np.testing.assert_array_equal(got, rowwise_kth_value_plain(torch.from_numpy(x), k).numpy())
    np.testing.assert_array_equal(got, distinct_kth(np.where(x <= NEG_INF, NEG_INF, x), k))
