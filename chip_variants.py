"""Registers, spills and device times of the design variants tried for the
bf16 dQ kernel and the decode kernel, from one call on one GPU (the bf16
forward and dK/dV kernels have none here).

    python3 chip_variants.py

Each variant is this tree's CUDA source with the lines listed in VARIANTS
replaced, so what was tried stays on record beside what was built.  Each is
compiled by nvcc into a directory of its own under build/variants/, its
hd-128 instances reported (-Xptxas -v: registers, spill bytes), checked
against the plain version and timed at its main-path shape with
repro_torch.timing.time_ms.  Every variant runs in a process of its own, in
the order listed and then in reverse.  Needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# the bf16 dQ kernel with Q's A fragments loaded once and held in registers
# (the forward's layout), instead of read by ldmatrix at each k-step
_DQ_Q_IN_REGISTERS = [
    ("""  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);   // into the stage freed last iteration
    cp_async_commit();
    cp_async_wait<1>();                      // tile it (and Q, dO) have landed
    __syncthreads();
""", """  uint32_t qh[KT][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);   // into the stage freed last iteration
    cp_async_commit();
    cp_async_wait<1>();                      // tile it (and Q, dO) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldmatrix_x4(qh[kk], Qs + (warp * 16 + lo.a_row) * LD + kk * 16 + lo.a_col);
    }
"""),
    ("""        uint32_t qa[4];
        ldmatrix_x4(qa, Qs + (warp * 16 + lo.a_row) * LD + kk * 16 + lo.a_col);
""", """        const uint32_t (&qa)[4] = qh[kk];
"""),
]


def _chunk(c: int):
    return [("constexpr int kChunk = 128;", f"constexpr int kChunk = {c};")]


# name -> (source, replacements, decode chunk)
VARIANTS = {
    "dq_kernel_bf16: Q and dO by ldmatrix at each k-step (built)":
        ("terapipe_attention_bwd", [], None),
    "dq_kernel_bf16: Q held in registers": ("terapipe_attention_bwd", _DQ_Q_IN_REGISTERS, None),
    "decode: 128-key chunks (built)": ("decode_attention", [], 128),
    "decode: 64-key chunks": ("decode_attention", _chunk(64), 64),
    "decode: 256-key chunks": ("decode_attention", _chunk(256), 256),
}


def _one(index: int) -> None:
    """Build, check and time variant ``index`` of VARIANTS."""
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, terapipe_attention_dq_ref

    name = list(VARIANTS)[index]
    source, replacements, chunk = VARIANTS[name]
    csrc = HERE / "build" / "variants" / str(index)
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    path = csrc / f"{source}.cu"
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to replace is not in {source}.cu once: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    _build.CSRC, _build.BUILD_DIR = csrc, csrc / "lib"
    lib = _build.build_all([source])[source]
    report = cs._ptxas_report(Path(str(lib) + ".log").read_text())

    gen = torch.Generator(device="cuda").manual_seed(1)
    if chunk is None:
        kernels = ["dq_kernel_bf16<128>"]
        args = cs._bwd_inputs(cs.TRAIN_BATCH, cs.TRAIN_SEQ, 0, 16, 16, 128, 1.0,
                              torch.bfloat16, gen, tail=0) + (0,)
        fn = lambda: cs.terapipe_attention_dq(*args)
        err = cs._err(fn(), terapipe_attention_dq_ref(*args), cs.TOL[torch.bfloat16], name)
        shape = "B=4 l=2048 ctx=0 Hq=Hkv=16 hd=128 bf16"
    else:
        decode_attention.CHUNK = chunk
        kernels = [f"{k}<bf16,128>" for k in cs.DECODE_KERNELS]
        b, L, hq, hkv, hd, kv_len = cs.SERVE_ROUND
        q = cs._rand((b, 1, hq, hd), torch.bfloat16, gen)
        k = cs._rand((b, L, hkv, hd), torch.bfloat16, gen)
        v = cs._rand((b, L, hkv, hd), torch.bfloat16, gen)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        fn = lambda: decode_attention.decode_attention_kernel(q, k, v, lens)
        err = cs._err(fn(), decode_attention_ref(q, k, v, lens), cs.TOL[torch.bfloat16], name)
        shape = f"B={b} L={L} kv_len={kv_len} Hq={hq} Hkv={hkv} hd={hd} bf16"
    regs = "; ".join(f"{kn}: {report[kn]['regs']} registers, spill stores "
                     f"{report[kn]['spill_stores']} B, loads {report[kn]['spill_loads']} B"
                     for kn in kernels)
    print(f"[variant] {name} ({shape}): {cs.time_ms(fn):.4f} ms, max abs err {err:.3g}; "
          f"{regs}", flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        _one(int(argv[2]))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip()}", flush=True)
    order = list(range(len(VARIANTS)))
    for i in order + order[::-1]:
        subprocess.run([sys.executable, __file__, "--one", str(i)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
