"""The tile walks of the bf16 forward, dQ and dK/dV kernels
(``repro_torch.kernels.tile_walk``, the plain statement of what
``csrc/terapipe_attention_fwd.cu::fwd_kernel_bf16`` and
``csrc/terapipe_attention_bwd.cu::dq_kernel_bf16`` and ``::dkv_kernel_bf16``
load, compute and mask) against the brute-force mask of
``repro_torch.kernels.ref.attention_mask``: every pair the mask allows is
computed exactly once (per query head, for dK/dV), no unmasked tile holds a
pair the mask refuses, and nothing is loaded past a frontier or loaded and
not computed.  The decode kernel's split (``tile_walk.decode_spans``) covers
the valid keys once, in rank order.  Hypothesis draws l,
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


@pytest.mark.parametrize("l,ctx,tail,rep,hd", KERNEL_CASES)
def test_dq_walk_at_its_tiles(l, ctx, tail, rep, hd):
    """dQ's walk (the forward's, at DQ_BQ rows and dq_bk(hd) keys: 32 at hd
    160) on the main paths' shapes."""
    assert tw.dq_walk(l, ctx, hd) == tw.fwd_walk(l, ctx, tw.DQ_BQ, tw.dq_bk(hd), tw.GROUP)
    check_fwd(l, ctx, tail, tw.DQ_BQ, tw.dq_bk(hd), tw.GROUP)


C, BOX = tw.DECODE_CLUSTER, tw.DECODE_BOX


@pytest.mark.parametrize("kv_len", [0, 1, C - 1, C, BOX * C - 1, BOX * C + 1, 2048])
def test_decode_spans_cover_the_keys_once(kv_len):
    """The decode cluster's ranks read [0, kv_len) exactly once, in key
    order, each span a whole number of boxes but the last non-empty one,
    the empty spans at the end (L = 2048, the serving cache)."""
    spans = tw.decode_spans(kv_len)
    assert len(spans) == C
    covered = [k for (a, b) in spans for k in range(a, b)]
    assert covered == list(range(kv_len))
    starts = [a for a, _ in spans]
    assert starts == sorted(starts)
    width = -(-(-(-kv_len // C)) // BOX) * BOX
    for a, b in spans:
        assert b - a in (0, width) or b == kv_len
        assert a % BOX == 0 or a == b == kv_len
    empty = [b == a for a, b in spans]
    assert empty == sorted(empty)                # the empty spans come last


@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_warps_fill_the_stage_budget(itemsize):
    """The decode CTA's warps (one ring stage each) at every head dim: as
    many stages as the budget holds, 2 to 8; 4 at hd 128 in bf16, the
    serving path's."""
    for hd in (16, 32, 64, 96, 128, 160):
        w = tw.decode_warps(hd, itemsize)
        stage = 2 * BOX * hd * itemsize
        assert 2 <= w <= 8
        assert w * stage <= tw.DECODE_STAGE_BYTES or w == 2
        assert w == 8 or (w + 1) * stage > tw.DECODE_STAGE_BYTES
    assert tw.decode_warps(128, 2) == 4


def test_c_division_truncates_toward_zero():
    """The walk divides as the kernels' C does, not as Python floors."""
    assert [tw._div(a, 4) for a in (-5, -4, -1, 0, 3, 4, 5)] == [-1, -1, 0, 0, 0, 1, 1]
    assert tw._div(7, -2) == -3


def test_summary_at_the_training_shape():
    """gpt3-1b's layer (B 4, l 2048, Hq = Hkv = 16, hd 128): 1024 forward
    units, q tile i loading key tiles 0..i, both warpgroups computing all of
    them and masking the diagonal one; 1024 dQ units, q tile i loading the
    2i + 2 key tiles of 64, its first warpgroup computing 2i + 1 of them
    and each masking its diagonal tile; 1024 dK/dV units, key tile j
    streaming the 32 - 2j q tiles of 64 rows from 2j, each warpgroup masking
    the one that holds its keys' diagonal, and the second skipping the first
    (its rows precede the group's keys)."""
    s = tw.summary(2048, 0, 16, 16, 128, batch=4)
    assert s["fwd_units"] == s["dkv_units"] == 4 * 16 * 16
    assert s["fwd_tiles_loaded"] == 64 * sum(range(1, 17))
    assert s["fwd_tiles_computed"] == 2 * s["fwd_tiles_loaded"]
    assert s["fwd_tiles_masked"] == 2 * 64 * 16
    assert s["dq_units"] == 4 * 16 * 16
    assert s["dq_tiles_loaded"] == 64 * sum(2 * i + 2 for i in range(16))
    assert s["dq_tiles_computed"] == 64 * sum(4 * i + 3 for i in range(16))
    assert s["dq_tiles_masked"] == 2 * 64 * 16
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
