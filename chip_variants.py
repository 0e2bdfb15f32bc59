"""Registers, spills and device times of the design variants tried for the
bf16 dQ kernel and the decode kernel, from one call on one GPU (the bf16
forward and dK/dV kernels have none here); and where the decode kernel's
time goes.

    python3 chip_variants.py [NAME]
    python3 chip_variants.py --stamps

Each variant is this tree's CUDA source with the lines listed in VARIANTS
replaced, so what was tried stays on record beside what was built.  Each is
compiled by nvcc into a directory of its own under build/variants/, its
hd-128 instance on the main path reported (-Xptxas -v: registers, spill
bytes), checked against the plain version and timed at its main-path shape
(dQ: gpt3-1b's training step; decode: the serving round) with
repro_torch.timing.time_ms.  Every variant runs in a process of its own, in
the order listed and then in reverse (only those whose name holds NAME,
when given).  Needs one CUDA GPU and nvcc.

--stamps builds a copy of the decode kernel that writes %globaltimer at each
of its phases (STAMPS), launches it as repro_torch.timing.time_ms times a
call (L2 flushed, the device idle before it) at phase 9's decode shapes,
and prints per phase the median CTA's and the last CTA's time since the
first CTA started, medians over 7 launches; beside them the call's time
and the timing method's floor (one 4-element add_).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# dQ with 128-key K/V tiles at hd 128 (S and dP twice as wide: 64 registers
# each), in a two-stage ring, where shared memory holds no third
_DQ_BK_128 = [
    ("constexpr int kDqBK = HD <= 128 ? 64 : 32;", "constexpr int kDqBK = HD <= 128 ? 128 : 32;"),
    ("constexpr int kDqStages = 3;", "constexpr int kDqStages = 2;"),
]

# dQ without the overlap: each tile's exponentials wait for the previous
# tile's dS.K product
_DQ_NO_OVERLAP = [
    ("""        turn_pass();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);""", """        turn_pass();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);"""),
]


# name -> (source, replacements)
VARIANTS = {
    "dq_kernel_bf16: 64-key tiles, S and dP over the previous dS.K (built)":
        ("terapipe_attention_bwd", []),
    "dq_kernel_bf16: 128-key tiles, two stages": ("terapipe_attention_bwd", _DQ_BK_128),
    "dq_kernel_bf16: no overlap": ("terapipe_attention_bwd", _DQ_NO_OVERLAP),
    "decode_kernel: clusters of 8, 72 KB of boxes in flight (4 warps at hd 128; built)":
        ("decode_attention", []),
    "decode_kernel: clusters of 4":
        ("decode_attention", [("constexpr int kCluster = 8;", "constexpr int kCluster = 4;")]),
    "decode_kernel: 96 KB of boxes in flight (6 warps at hd 128, two CTAs an SM)":
        ("decode_attention", [("constexpr int kStageBudget = 72 * 1024;",
                               "constexpr int kStageBudget = 96 * 1024;")]),
}


# The decode kernel's phases: (name, a line of decode_attention.cu, True to
# stamp before it, False after it, None to replace it, the stamp's
# statement); each CTA's thread 0 (warp 0: box 0 is its first box) records
# them in this order
STAMPS = [
    ("start", "  const int tid = threadIdx.x, lane = tid % 32;\n", True,
     "  const unsigned long long s0 = gtime(0);\n"
     "  unsigned long long s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0;\n"),
    ("kv_len known", "  __syncthreads();                             // the barriers are initialised\n",
     True, "  s1 = gtime(nb);\n"),
    ("box 0 landed", "    sm90::bar_wait(k_full + warp, it & 1);\n", False,
     "    if (it == 0) s2 = gtime(0);\n"),
    ("box 0 scores", "    __syncwarp();                               // every lane is done with K\n",
     True, "    if (it == 0) s3 = gtime(0);\n"),
    ("box 0 softmax", "    // the V rows of keys at and past kv_len zeroed, so that P.V runs over\n",
     True, "    if (it == 0) s4 = gtime(0);\n"),
    ("box 0 P.V", "    __syncwarp();                               // every lane is done with V\n",
     False, "    if (it == 0) s5 = gtime(0);\n"),
    ("boxes done", "  // the warps' states (where the stages were", True,
     "  const unsigned long long s6 = gtime(0);\n"),
    ("CTA merged", "  // every rank's state is written; rank `rank` merges its dims of each head\n",
     True, "  const unsigned long long s7 = gtime(0);\n"),
    ("cluster barrier 1", "  sm90::cluster_sync();\n  for (int idx = tid; idx < nrows * DPR;", None,
     "  sm90::cluster_sync();\n  const unsigned long long s8 = gtime(0);\n"
     "  for (int idx = tid; idx < nrows * DPR;"),
    ("outputs written", "  sm90::cluster_sync();                         // no CTA leaves", True,
     "  const unsigned long long s9 = gtime(0);\n"),
    ("cluster barrier 2", "// no CTA leaves while its state is read\n", False,
     "  const unsigned long long s10 = gtime(0);\n"
     "  if (tid == 0) {\n    unsigned long long* g = g_stamps + 16 * blockIdx.x;\n"
     + "".join(f"    g[{i}] = s{i};\n" for i in range(11)) + "  }\n"),
]
_STAMP_HEADER = """__device__ unsigned long long g_stamps[16 * 65536];
// %globaltimer (ns), read after `dep` is known
__device__ __forceinline__ unsigned long long gtime(int dep) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "r"(dep));
  return t;
}
"""
_STAMP_EXPORT = """
extern "C" int decode_stamps(void* dst, int n_cta) {
  return int(cudaMemcpyFromSymbol(dst, g_stamps, size_t(n_cta) * 16 * sizeof(unsigned long long)));
}
"""


def _patched(csrc: Path, source: str, replacements: list) -> str:
    """Copy the kernel sources to ``csrc`` with ``replacements`` made in
    ``source``.cu (each must be there once); returns its text."""
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(HERE / "src" / "repro_torch" / "kernels" / "csrc", csrc)
    path = csrc / f"{source}.cu"
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"the text to replace is not in {source}.cu once: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return text


def _stamps() -> None:
    """The stamped decode kernel's phases at phase 9's decode shapes."""
    import ctypes
    import statistics

    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch import timing
    from repro_torch.kernels import _build, decode_attention, tile_walk

    reps = [(at, at + add) if after is False else (at, add + at) if after else (at, add)
            for _, at, after, add in STAMPS]
    reps.insert(0, ("namespace {\n\nusing namespace repro;\n",
                    _STAMP_HEADER + "namespace {\n\nusing namespace repro;\n"))
    csrc = HERE / "build" / "variants" / "stamps"
    path = csrc / "decode_attention.cu"
    text = _patched(csrc, "decode_attention", reps)
    path.write_text(text + _STAMP_EXPORT)
    _build.CSRC, _build.BUILD_DIR = csrc, csrc / "lib"
    lib = _build.load("decode_attention")
    lib.decode_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    tiny = torch.zeros(4, device="cuda")
    print(f"[stamps] timing floor (one 4-element add_): {timing.time_ms(lambda: tiny.add_(1)):.4f} "
          f"ms", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (b, L, hq, hkv, hd, kv_len) in [cs.SERVE_ROUND] + cs.FAMILY_DECODE_CASES:
        q = cs._rand((b, 1, hq, hd), torch.bfloat16, gen)
        k = cs._rand((b, L, hkv, hd), torch.bfloat16, gen)
        v = cs._rand((b, L, hkv, hd), torch.bfloat16, gen)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda").reshape(-1).expand(b)
        lens = lens.contiguous()
        fn = lambda: decode_attention.decode_attention_kernel(q, k, v, lens)
        rep = hq // hkv
        rows = next(r for r in (1, 2, 4, 8) if r >= min(rep, 8))   # the kernel's R
        n_cta = tile_walk.DECODE_CLUSTER * b * hkv * -(-rep // rows)
        print(f"[stamps] decode B={b} L={L} kv_len={kv_len} Hq={hq} Hkv={hkv} hd={hd} bf16: "
              f"{timing.time_ms(fn):.4f} ms a call; since the first CTA started:", flush=True)
        runs = []
        for _ in range(7):
            flush.zero_()
            torch.cuda._sleep(timing.HOST_SLACK_CYCLES)
            fn()
            torch.cuda.synchronize()
            st = np.zeros((n_cta, 16), dtype=np.uint64)
            if lib.decode_stamps(st.ctypes.data, n_cta):
                raise RuntimeError("decode_stamps failed")
            st = st.astype(np.int64)
            runs.append(np.where(st > 0, st - st[:, 0].min(), -1))
        for i, (name, *_) in enumerate(STAMPS):
            # the box stamps of CTAs with keys to read
            busy = [r[r[:, i] >= 0] for r in runs]
            if not all(len(r) for r in busy):
                print(f"[stamps]   {name:18s} no CTA", flush=True)
                continue
            med = statistics.median(float(np.median(r[:, i])) for r in busy)
            last = statistics.median(float(r[:, i].max()) for r in busy)
            print(f"[stamps]   {name:18s} median CTA {med / 1e3:7.3f} us, last CTA "
                  f"{last / 1e3:7.3f} us", flush=True)


def _one(index: int) -> None:
    """Build, check and time variant ``index`` of VARIANTS."""
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, terapipe_attention_dq_ref

    name = list(VARIANTS)[index]
    source, replacements = VARIANTS[name]
    csrc = HERE / "build" / "variants" / str(index)
    _patched(csrc, source, replacements)
    _build.CSRC, _build.BUILD_DIR = csrc, csrc / "lib"
    lib = _build.build_all([source])[source]
    report = cs._ptxas_report(Path(str(lib) + ".log").read_text())

    gen = torch.Generator(device="cuda").manual_seed(1)
    if source == "terapipe_attention_bwd":
        kernel = "dq_kernel_bf16<128>"
        args = cs._bwd_inputs(cs.TRAIN_BATCH, cs.TRAIN_SEQ, 0, 16, 16, 128, 1.0,
                              torch.bfloat16, gen, tail=0) + (0,)
        fn = lambda: cs.terapipe_attention_dq(*args)
        err = cs._err(fn(), terapipe_attention_dq_ref(*args), cs.TOL[torch.bfloat16], name)
        shape = "B=4 l=2048 ctx=0 Hq=Hkv=16 hd=128 bf16"
    else:
        kernel = "decode_kernel<bf16,128,2>"   # the serving round's instance
        b, L, hq, hkv, hd, kv_len = cs.SERVE_ROUND
        q = cs._rand((b, 1, hq, hd), torch.bfloat16, gen)
        k = cs._rand((b, L, hkv, hd), torch.bfloat16, gen)
        v = cs._rand((b, L, hkv, hd), torch.bfloat16, gen)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        fn = lambda: decode_attention.decode_attention_kernel(q, k, v, lens)
        err = cs._err(fn(), decode_attention_ref(q, k, v, lens), cs.TOL[torch.bfloat16], name)
        shape = f"B={b} L={L} kv_len={kv_len} Hq={hq} Hkv={hkv} hd={hd} bf16"
    r = report[kernel]
    print(f"[variant] {name} ({shape}): {cs.time_ms(fn):.4f} ms, max abs err {err:.3g}; "
          f"{kernel}: {r['regs']} registers, spill stores {r['spill_stores']} B, loads "
          f"{r['spill_loads']} B", flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        _one(int(argv[2]))
        return 0
    if argv[1:] == ["--stamps"]:
        _stamps()
        return 0
    if len(argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip()}", flush=True)
    order = [i for i, name in enumerate(VARIANTS) if len(argv) == 1 or argv[1] in name]
    for i in order + order[::-1]:
        subprocess.run([sys.executable, __file__, "--one", str(i)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
