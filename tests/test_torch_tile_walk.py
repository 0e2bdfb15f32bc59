"""The tile walk of the bf16 forward and dK/dV kernels
(``repro_torch.kernels.tile_walk``, the plain statement of what
``csrc/terapipe_attention_fwd.cu::fwd_kernel_bf16`` and
``csrc/terapipe_attention_bwd.cu::dkv_kernel_bf16`` load, compute and mask)
against the brute-force mask of ``repro_torch.kernels.ref.attention_mask``:
every pair the mask allows is computed exactly once (per query head, for
dK/dV), no unmasked tile holds a pair the mask refuses, and nothing is
loaded past a frontier or loaded and not computed.  Hypothesis draws l,
ctx, the stale tail, the GQA ratio and the tile sizes; the kernels' own
sizes are checked on the main paths' shapes.  The frontier arithmetic
divides as C does (truncating toward zero), so a division of a negative
``k0 - ctx`` would show here."""
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import tile_walk as tw
from repro_torch.kernels.ref import attention_mask

# the suite runs several workers on the same cores
torch.set_num_threads(1)


def _padded_mask(l, ctx, sk, rows, keys):
    """attention_mask, padded with refused pairs to rows x keys."""
    out = torch.zeros((rows, keys), dtype=torch.bool)
    out[:l, :sk] = attention_mask(l, ctx, sk)
    return out


def check_fwd(l, ctx, tail, bq, bk, group):
    sk = ctx + l + tail
    nq = -(-l // bq)
    mask = _padded_mask(l, ctx, sk, nq * bq, -(-sk // bk) * bk + bk)
    covered = torch.zeros_like(mask, dtype=torch.int)
    units = tw.fwd_walk(l, ctx, bq, bk, group)
    assert [u.iq for u in units] == list(range(nq))[::-1]       # longest frontier first
    for blk in units:
        q0 = blk.iq * bq
        frontier = ctx + min(q0 + bq, l)
        # the ring loads up to the frontier and no tile past it
        assert (blk.n_loaded - 1) * bk < frontier <= blk.n_loaded * bk
        computed = set()
        for wg, visits in enumerate(blk.groups):
            w0 = q0 + group * wg
            assert [t for t, _ in visits] == list(range(len(visits)))   # a prefix
            assert 1 <= len(visits) <= blk.n_loaded
            for t, masked in visits:
                sub = mask[w0:w0 + group, t * bk:(t + 1) * bk]
                if not masked:
                    assert sub.all(), (l, ctx, blk.iq, wg, t)
                # a group with rows computes only tiles that hold its pairs
                assert sub.any() or w0 >= l, (l, ctx, blk.iq, wg, t)
                covered[w0:w0 + group, t * bk:(t + 1) * bk] += sub
                computed.add(t)
        assert computed == set(range(blk.n_loaded))          # no load wasted
    assert torch.equal(covered, mask.int())                  # each pair once


def check_dkv(l, ctx, tail, rep, bq, bk, group):
    sk = ctx + l + tail
    nq = -(-l // bq)
    mask = _padded_mask(l, ctx, sk, nq * bq, -(-sk // bk) * bk)
    covered = torch.zeros((rep,) + mask.shape, dtype=torch.int)
    units = tw.dkv_walk(l, ctx, sk, rep, bq, bk, group)
    assert [u.ik for u in units] == list(range(-(-sk // bk)))
    for blk in units:
        k0 = blk.ik * bk
        if blk.zeros_only:
            assert k0 >= ctx + l and not blk.items
            continue
        assert k0 < ctx + l
        heads = [h for h, _ in blk.items]
        assert heads == sorted(heads) and set(heads) == set(range(rep))
        computed = set()
        for wg, visits in enumerate(blk.groups):
            kw0 = k0 + group * wg
            for it, masked in visits:
                h, iq = blk.items[it]
                assert 0 <= iq < nq
                sub = mask[iq * bq:(iq + 1) * bq, kw0:kw0 + group]
                if not masked:
                    assert sub.all(), (l, ctx, blk.ik, wg, h, iq)
                assert sub.any(), (l, ctx, blk.ik, wg, h, iq)
                covered[h, iq * bq:(iq + 1) * bq, kw0:kw0 + group] += sub
                computed.add(it)
        assert computed == set(range(len(blk.items)))        # no load wasted
    for h in range(rep):
        assert torch.equal(covered[h], mask.int())


@settings(max_examples=150, deadline=None)
@given(l=st.integers(1, 300), ctx=st.integers(0, 300), tail=st.integers(0, 40),
       bq=st.sampled_from([32, 64, 128]), bk=st.sampled_from([16, 32, 64, 128]),
       groups=st.sampled_from([1, 2, 4]))
def test_fwd_walk_covers_the_mask(l, ctx, tail, bq, bk, groups):
    """The forward's walk at drawn shapes and tile sizes."""
    check_fwd(l, ctx, tail, bq, bk, bq // groups)


@settings(max_examples=150, deadline=None)
@given(l=st.integers(1, 300), ctx=st.integers(0, 300), tail=st.integers(0, 40),
       rep=st.sampled_from([1, 2, 3, 4]), bq=st.sampled_from([16, 32, 64]),
       bk=st.sampled_from([32, 64, 128]), groups=st.sampled_from([1, 2, 4]))
def test_dkv_walk_covers_the_mask(l, ctx, tail, rep, bq, bk, groups):
    """The dK/dV kernel's walk at drawn shapes, GQA ratios and tile sizes."""
    check_dkv(l, ctx, tail, rep, bq, bk, bk // groups)


# (l, ctx, tail, rep, hd): serving chunks (l 1, 8 at ctx 250), ragged 33 and
# 100 rows, ctx not a multiple of any tile, the pipelined slices, GQA 16,
# hd 160's 32-row dK/dV tiles, and the training shape
KERNEL_CASES = [(1, 0, 37, 2, 128), (8, 250, 37, 2, 128), (33, 17, 37, 4, 64),
                (100, 256, 37, 2, 160), (200, 100, 37, 4, 128), (256, 256, 0, 1, 128),
                (256, 1792, 0, 1, 128), (256, 256, 37, 16, 128), (2048, 0, 37, 1, 128)]


@pytest.mark.parametrize("l,ctx,tail,rep,hd", KERNEL_CASES)
def test_walks_at_the_kernels_tiles(l, ctx, tail, rep, hd):
    """Both walks at the kernels' own tile sizes on the main paths' shapes."""
    check_fwd(l, ctx, tail, tw.FWD_BQ, tw.FWD_BK, tw.GROUP)
    check_dkv(l, ctx, tail, rep, tw.dkv_bq(hd), tw.DKV_BK, tw.GROUP)


def test_c_division_truncates_toward_zero():
    """The walk divides as the kernels' C does, not as Python floors."""
    assert [tw._div(a, 4) for a in (-5, -4, -1, 0, 3, 4, 5)] == [-1, -1, 0, 0, 0, 1, 1]
    assert tw._div(7, -2) == -3


def test_summary_at_the_training_shape():
    """gpt3-1b's layer (B 4, l 2048, Hq = Hkv = 16, hd 128): 1024 forward
    units, q tile i loading key tiles 0..i, both warpgroups computing all of
    them and masking the diagonal one; 1024 dK/dV units, key tile j
    streaming the 32 - 2j q tiles of 64 rows from 2j, each warpgroup masking
    the one that holds its keys' diagonal, and the second skipping the first
    (its rows precede the group's keys)."""
    s = tw.summary(2048, 0, 16, 16, 128, batch=4)
    assert s["fwd_units"] == s["dkv_units"] == 4 * 16 * 16
    assert s["fwd_tiles_loaded"] == 64 * sum(range(1, 17))
    assert s["fwd_tiles_computed"] == 2 * s["fwd_tiles_loaded"]
    assert s["fwd_tiles_masked"] == 2 * 64 * 16
    assert s["dkv_items_loaded"] == 64 * sum(32 - 2 * j for j in range(16))
    assert s["dkv_items_computed"] == 2 * s["dkv_items_loaded"] - 64 * 16
    assert s["dkv_items_masked"] == 2 * 64 * 16


@pytest.mark.parametrize("n_units,grid", [(1024, 132), (128, 128), (16, 16), (2048, 132),
                                          (133, 132), (7, 3)])
def test_deal_takes_every_unit_once(n_units, grid):
    """The persistent kernels' zigzag deal: every unit once, each block's
    in rising order, and at the training shape's forward (units numbered
    longest frontier first, q tile iq walking iq + 1 key tiles) no block
    more than a tenth above the mean."""
    deal = tw.deal(n_units, grid)
    assert sorted(i for mine in deal for i in mine) == list(range(n_units))
    assert all(mine == sorted(mine) for mine in deal)
    if (n_units, grid) == (1024, 132):
        work = [sum(16 - i // 64 for i in mine) for mine in deal]
        assert max(work) <= 1.1 * sum(work) / grid
