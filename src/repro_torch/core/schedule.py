"""Slicing schemes: the paper's [(b, [l_1..l_M])] * D notation, validated
(reference: ``repro/core/schedule.py``, copied: the port imports nothing of
the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SlicingScheme:
    """A minibatch execution plan.

    ``splits`` is a list of (batch_slice_size, token_slice_lengths); e.g. the
    paper's  [(1, [704, 688, 656])] * 32  is 32 batch slices of one sequence,
    each cut into three token slices.
    """
    seq_len: int
    batch: int
    splits: Tuple[Tuple[int, Tuple[int, ...]], ...]

    def __post_init__(self):
        assert sum(b for b, _ in self.splits) == self.batch, \
            f"batch splits {self.splits} != batch {self.batch}"
        for b, ls in self.splits:
            assert b >= 1
            assert sum(ls) == self.seq_len, f"token slices {ls} != L {self.seq_len}"
            assert all(l >= 1 for l in ls)

    @property
    def n_ticks(self) -> int:
        return sum(len(ls) for _, ls in self.splits)

    @classmethod
    def uniform(cls, seq_len: int, batch: int, *, n_token_slices: int = 1,
                microbatch: int = 0) -> "SlicingScheme":
        mb = microbatch or batch
        assert batch % mb == 0 and seq_len % n_token_slices == 0
        l = seq_len // n_token_slices
        split = (mb, tuple([l] * n_token_slices))
        return cls(seq_len, batch, tuple([split] * (batch // mb)))

    @classmethod
    def from_dp(cls, seq_len: int, batch: int,
                scheme: Sequence[Tuple[int, Sequence[int]]]) -> "SlicingScheme":
        return cls(seq_len, batch,
                   tuple((b, tuple(ls)) for b, ls in scheme))

    def describe(self) -> str:
        # compress equal consecutive splits, paper-style
        out, i = [], 0
        sp = list(self.splits)
        while i < len(sp):
            j = i
            while j < len(sp) and sp[j] == sp[i]:
                j += 1
            out.append(f"({sp[i][0]}, {list(sp[i][1])})" +
                       (f" * {j - i}" if j - i > 1 else ""))
            i = j
        return "[" + ", ".join(out) + "]"
