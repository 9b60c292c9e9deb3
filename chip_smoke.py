#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving paths and federation on one
CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX.  Every phase raises on a mismatch, so the exit code is non-zero if
any phase fails:

1. build   — compile the three kernels from ``src/repro_torch`` (one
             ``nvcc`` each, all started together); print what
             ``nvcc -Xptxas -v`` reports for them (registers, spills and
             warnings of both flash designs at every head_dim and both
             ssd_intra designs, ``wgmma`` and ``simt``), each design's
             shared memory, and the count of HGMMA instructions in the
             flash and ssd_scan libraries' SASS, neither of which may be 0;
2. kernel  — each kernel against its plain PyTorch version:
             flash attention at gemma2-2b's widths (hd 256, softcap 50) and
             mixtral-8x22b's (hd 128, no softcap) and every (B, S, window)
             their engines give it, with a control that must fail the same
             check (softcap off; without a softcap, window 0 or no causal
             mask), the design that ran and its TFLOP/s;
             ssd_intra at mamba2-780m's widths and every (B, NC, Q) the
             mamba2 engines give it, and at the smoke widths, with a
             no-decay control; the design that ran, its TFLOP/s, kernel,
             plain, library and bound times (fp32 CUDA cores, and the
             tensor cores' 3xTF32 route);
3. serve   — gemma2-2b: a small model on the card against the same model
             on the CPU, then full width (random weights from seed 0) in
             engines A (short prompts, batch 4) and B (one 4352-token
             prompt through the sliding window), every flash launch on
             the ``wgmma`` design;
             mamba2-780m: the chunk checksum of every parameter leaf in
             one launch, exactly equal to its plain version, with a
             flipped-byte control, timed as the launch alone (its table
             built once) and with the host's work; a small model
             card-vs-CPU check; then full width (random weights from
             seed 0): ``param_checksums`` (one launch, host clock) and
             engines C (8 prompts of 64-1000 tokens, batch 4) and D (one
             8000-token prompt, 32 chunks), every ssd_intra launch on the
             ``wgmma`` design;
             mixtral-8x22b, after the earlier paths' weights are freed: a
             small model card-vs-CPU check whose routing (expert, slot,
             kept) is equal on both and drops pairs; then full width, 8
             of 56 layers (the only cut; random weights from seed 0): the
             checksum of every leaf (41 GB as bytes) in one launch,
             exactly equal to its plain version (run in 64 MB pieces),
             with a flipped-byte control; ``param_checksums`` (one
             launch); engines E (8
             prompts of 64-256 tokens, batch 4) and F (one 4352-token
             prompt through the 4096 window), every flash launch on the
             ``wgmma`` design, with the share of each wave and decode
             step that the MoE layers, their routing and their expert
             products take;
4. federation — the port's data plane on the simulated engine, its
             max-min solver on the card (torch ops):
             G: the paper's §4.1 protocol at the five OSG sites (four
             sequential fetches of each evaluation file: proxy cold and
             warm, stash cold and warm) on solver "auto" and, with every
             solve on the card, on "vector", within 1e-4 of "auto" and
             equal byte for byte to its CPU run; download speeds and
             Table 3 beside the paper's;
             H: a restart storm over a 250-pod fleet (1,000 workers pull
             a 2 GB checkpoint within 2 s), every solve on the card: its
             counters against the reference's, a second run equal byte
             for byte, the scalar solver's run with equal counters and
             seconds within 1e-4, and at three recorded solves (the peak
             among them) the card's rates against the float64 oracle and
             the same ops on the CPU, each with a control that must fail;
             solves, flows, rounds, host syncs and copies per solve, ms
             per solve against the scalar solver's, the share of the wall
             time spent solving;
5. report  — one JSON line of kernel numbers, then the device line.

Each serving path and storm H runs with every launch count set to 0 just
before it and read just after.  Every line with a measured number names
the card and its power limit.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


class Widths(NamedTuple):
    """The attention widths a model gives the flash kernel."""
    h: int              # q-heads
    kv: int             # KV heads
    hd: int             # head_dim
    softcap: float


GEMMA2 = Widths(16, 4, 256, 50.0)      # 16 q-heads, 8 of them zero pads
MIXTRAL = Widths(48, 8, 128, 0.0)
# q at 4x unit scale gives scores of std 4, where the softcap bends the
# top scores (50·tanh(16/50) is 15.47); the model's own q and k are larger
Q_SCALE = 4.0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOLERANCE = {"bfloat16": "2^-7·|want| + 1e-3 (one bf16 ulp)",
             "float32": "1e-4"}
SSD_RTOL = 1e-4
SSD_TOLERANCE = "1e-4 + 1e-4·|want|"
ENGINE_A_BATCH = 4
ENGINE_C_BATCH = 4
ENGINE_D_PROMPT = 8000
ENGINE_F_PROMPT = 4352
MIXTRAL_LAYERS = 8               # of 56: the bf16 weights, 40.9 GB, fit
SSD_MAIN_CASE = "B1 NC32 Q256 H48 P64 N128"    # engine D's long prompt
# kernel: (its source, the TPU kernel it replaces)
KERNEL_FILES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:27"),
    "ssd_intra": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                  "src/repro/kernels/ssd_scan.py:24"),
    "chunk_checksum": ("src/repro_torch/kernels/csrc/chunk_checksum.cu",
                       "src/repro/kernels/chunk_checksum.py:40")}


def engine_a_lengths(rng):
    """Engine A's 8 prompt lengths, the first draw from its generator."""
    return rng.integers(64, 257, size=8)


def engine_c_lengths(rng):
    """Engine C's 8 prompt lengths, the first draw from its generator."""
    return rng.integers(64, 1001, size=8)


def _wave_lengths(lengths, batch):
    return [int(lengths[i:i + batch].max())
            for i in range(0, len(lengths), batch)]


def kernel_cases():
    """(widths, B, S, window, dtype): every shape the serve phase gives the
    flash kernel in bf16 (gemma2: engine A's two waves, engine B's
    windowed and global layers; mixtral: engine E's two waves, the same
    lengths as A's, and engine F's windowed layers), then edge cases and
    float32 at both head dims."""
    import numpy as np
    waves = _wave_lengths(engine_a_lengths(np.random.default_rng(0)),
                          ENGINE_A_BATCH)
    return [
        *[(GEMMA2, ENGINE_A_BATCH, s, 0, "bfloat16") for s in waves],
        (GEMMA2, 1, 4352, 4096, "bfloat16"),
        (GEMMA2, 1, 4352, 0, "bfloat16"),
        (GEMMA2, 1, 1024, 0, "bfloat16"),
        (GEMMA2, 1, 1024, 0, "float32"),
        (GEMMA2, 1, 96, 0, "bfloat16"),            # ragged
        (GEMMA2, 1, 96, 0, "float32"),
        (GEMMA2, 1, 512, 64, "bfloat16"),
        *[(MIXTRAL, ENGINE_A_BATCH, s, 0, "bfloat16") for s in waves],
        (MIXTRAL, 1, ENGINE_F_PROMPT, 4096, "bfloat16"),
        (MIXTRAL, 1, 1024, 0, "float32"),
        (MIXTRAL, 1, 300, 100, "float32"),
    ]


def _chunks(length: int, chunk: int):
    """(NC, Q) of ``ssd_chunked`` for a sequence of ``length``."""
    q = min(chunk, length)
    return -(-length // q), q


def ssd_cases():
    """(B, NC, Q, H, P, N): every shape the mamba2 engines give the
    ssd_intra kernel (engine C's two waves, engine D's prompt), then the
    smoke config's widths."""
    import numpy as np
    waves = _wave_lengths(engine_c_lengths(np.random.default_rng(0)),
                          ENGINE_C_BATCH)
    return [*[(ENGINE_C_BATCH, *_chunks(s, 256), 48, 64, 128) for s in waves],
            (1, *_chunks(ENGINE_D_PROMPT, 256), 48, 64, 128),
            (2, 5, 8, 8, 16, 16)]


def case_name(w: Widths, b: int, s: int, window: int, dtype: str) -> str:
    band = f"window{window}" if window else "causal"
    return f"B{b} S{s} {band} {dtype} H{w.h} KV{w.kv} hd{w.hd}"


# engine B's and engine F's windowed layers
MAIN_CASE = case_name(GEMMA2, 1, 4352, 4096, "bfloat16")
MAIN_CASE_128 = case_name(MIXTRAL, 1, ENGINE_F_PROMPT, 4096, "bfloat16")


def ssd_name(b, nc, q, h, p, n) -> str:
    return f"B{b} NC{nc} Q{q} H{h} P{p} N{n}"


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def say(msg: str, card: str) -> None:
    print(f"{msg}  [{card}]", flush=True)


def time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernels():
    from repro_torch.kernels import chunk_checksum, flash_attention, ssd_scan
    return {"flash_attention": flash_attention.KERNEL,
            "ssd_intra": ssd_scan.KERNEL,
            "chunk_checksum": chunk_checksum.KERNEL}


def _reset_counts() -> None:
    for kernel in _kernels().values():
        kernel.launches = 0
        if hasattr(kernel, "launches_by_design"):
            kernel.launches_by_design = dict.fromkeys(
                kernel.launches_by_design, 0)


# ---------------------------------------------------------------------------
def phase_build(card: str) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_checksum as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    libs = (fa.LIB, ssd_scan.LIB, cc.LIB)
    t0 = time.perf_counter()
    _build.build(*libs)
    say(f"build: {', '.join(lib.path.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)", card)
    entries = {"flash_wgmma": "wgmma design: ",
               "flash_attention_kernel": "simt design: ",
               "ssd_wgmma_kernel": "wgmma design: ",
               "ssd_simt_kernel": "simt design: "}
    for lib in libs:
        design = ""
        for line in lib.ptxas_report.read_text().splitlines():
            if "compiling entry" in line.lower():
                design = next((d for e, d in entries.items() if e in line),
                              "")
            if any(w in line.lower() for w in ("compiling entry",
                                               "registers", "spill",
                                               "warning")):
                entry = line.split(':', 1)[-1].strip()
                say(f"ptxas {lib.name}: {design}{entry}", card)
    say("dynamic shared memory per block: " + ", ".join(
        f"flash {fa.KERNEL.design(dtype, hd)} ({str(dtype)[6:]}, hd {hd}): "
        f"{fa.KERNEL.smem_bytes(dtype, hd)} B" for dtype, hd in fa.DESIGNS)
        + ", " + ", ".join(f"ssd_intra {ssd_scan.KERNEL.design(p, n)} "
                           f"(P {p}, N {n}, Q 256): "
                           f"{ssd_scan.KERNEL.smem_bytes(p, n, 256)} B"
                           for p, n in ssd_scan.DESIGNS), card)
    for lib in (fa.LIB, ssd_scan.LIB):
        sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                               str(lib.path)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        hgmma = sum(line.count("HGMMA") for line in sass.splitlines())
        say(f"SASS of {lib.path.name}: {hgmma} HGMMA instructions", card)
        if not hgmma:
            raise AssertionError(f"the {lib.name} library's SASS holds no "
                                 f"HGMMA instruction")


def _bound(flops: float, peak: float, nbytes: int):
    """Least time for the work: the larger of its operations over the
    type's peak and its bytes (each input read once, each output written
    once) over HBM."""
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _flash_flops(w: Widths, b: int, s: int, window: int) -> int:
    """Matrix-product FLOPs of the valid (row, column) pairs only."""
    pairs = sum(r - (max(0, r - window + 1) if window else 0) + 1
                for r in range(s))
    return 4 * b * w.h * w.hd * pairs


def phase_flash_kernel(card: str) -> dict:
    """Each case: the kernel against the plain version within the stated
    tolerance, and a control that must fall outside it, so the check is
    known to see what the case tests: with a softcap, the kernel with the
    softcap off against the plain version with it on; without one (no
    softcap to switch off), the kernel without its band: window 0 on a
    windowed case, no causal mask on the others."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import KERNEL

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for w, b, s, window, dtype_name in kernel_cases():
        dtype = getattr(torch, dtype_name)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device="cuda")
                    ).to(dtype)
        q, k, v = rand(b, s, w.h, w.hd, scale=Q_SCALE), \
            rand(b, s, w.kv, w.hd), rand(b, s, w.kv, w.hd)
        kw = dict(causal=True, window=window, softcap=w.softcap)
        design = KERNEL.design(dtype, w.hd)
        got = KERNEL(q, k, v, **kw)
        if w.softcap:
            control_kind = "softcap-off"
            control = KERNEL(q, k, v, causal=True, window=window, softcap=0.0)
        else:
            control_kind = "window-0" if window else "non-causal"
            control = KERNEL(q, k, v, causal=bool(window), window=0)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        name = case_name(w, b, s, window, dtype_name)
        if got.dtype != dtype or got.shape != q.shape:
            raise AssertionError(f"kernel {name}: got {got.dtype} "
                                 f"{tuple(got.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        ratio = ref.err_over_tolerance(got, want)
        control_ratio = ref.err_over_tolerance(control, want)
        tol = TOLERANCE[dtype_name]
        if not ratio <= 1.0:
            raise AssertionError(f"kernel {name}: error {ratio} times the "
                                 f"tolerance {tol} (max_abs_err {err})")
        if not control_ratio > 1.0:
            raise AssertionError(f"kernel {name}: the {control_kind} control "
                                 f"is within tolerance ({control_ratio}); "
                                 f"the check cannot see what it changes")
        iters = max(20, min(200, int(2e10 // (b * s * s * w.h * w.hd))))
        kernel_ms = time_ms(lambda: KERNEL(q, k, v, **kw), iters)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                           max(2, iters // 4))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
        nbytes = 2 * (q.nbytes + k.nbytes)           # q, k, v, o
        flops = _flash_flops(w, b, s, window)
        bound_ms, bound_by = _bound(flops, PEAK_FLOPS[dtype_name], nbytes)
        tflops = flops / kernel_ms / 1e9
        results[name] = dict(max_abs_err=err, err_over_tol=ratio,
                             control_err_over_tol=control_ratio,
                             control=control_kind, ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             tflops=tflops, design=design)
        say(f"kernel flash {name} ({design} design): max_abs_err={err:.3e} "
            f"err/tol={ratio:.3f} {control_kind} control "
            f"err/tol={control_ratio:.3f} (tol {tol}) "
            f"kernel_ms={kernel_ms:.4f} ({tflops:.1f} TFLOP/s) "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (sdpa "
            f"causal, no window, softcap 0) bound_ms={bound_ms:.4f} "
            f"({bound_by})", card)
        del q, k, v, got, control, want, qt, kt, vt
        torch.cuda.empty_cache()
    return results


def phase_ssd_kernel(card: str) -> dict:
    """Each case: the kernel against the plain version within
    ``SSD_TOLERANCE``, and a control that must fall outside it: the plain
    version with cum set to 0 (no decay) as the reference.  dt and the
    per-row log-decay are softplus of a normal (a = −1, as the model's
    init gives), so exp(cum_i − cum_j) overflows above the diagonal."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import KERNEL

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, nc, q, h, p, n in ssd_cases():
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x, b_in, c_in = rand(b, nc, q, h, p), rand(b, nc, q, n), \
            rand(b, nc, q, n)
        dt = F.softplus(rand(b, nc, q, h))
        cum = torch.cumsum(-F.softplus(rand(b, nc, q, h)), dim=2)
        args = (x, dt, cum, b_in, c_in)
        design = KERNEL.design(p, n)
        by_design = KERNEL.launches_by_design[design]
        got = KERNEL(*args)
        if KERNEL.launches_by_design[design] != by_design + 1:
            raise AssertionError(f"ssd_intra: the launch was not counted "
                                 f"under {design}")
        want = ref.ssd_intra_ref(*args)
        control = ref.ssd_intra_ref(x, dt, torch.zeros_like(cum), b_in, c_in)
        torch.cuda.synchronize()
        name = ssd_name(b, nc, q, h, p, n)
        if got.shape != x.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ssd_intra {name}: non-finite or "
                                 f"misshapen output {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        ratio = ref.err_over_tolerance(got, want, rtol=SSD_RTOL)
        control_ratio = ref.err_over_tolerance(got, control, rtol=SSD_RTOL)
        if not ratio <= 1.0:
            raise AssertionError(f"ssd_intra {name}: error {ratio} times the "
                                 f"tolerance {SSD_TOLERANCE} (max_abs_err "
                                 f"{err})")
        if not control_ratio > 1.0:
            raise AssertionError(f"ssd_intra {name}: the no-decay control is "
                                 f"within tolerance ({control_ratio}); the "
                                 f"check cannot see the decay")
        iters = max(10, min(200, int(2e9 // (b * nc * q * q * h * p))))
        kernel_ms = time_ms(lambda: KERNEL(*args), iters)
        plain_ms = time_ms(lambda: ref.ssd_intra_ref(*args),
                           max(2, iters // 4))
        # scores once per (b, c), then one product per head
        flops = b * nc * q * (q + 1) // 2 * (2 * n + 2 * h * p)
        nbytes = sum(t.nbytes for t in args) + got.nbytes
        bound_ms, bound_by = _bound(flops, PEAK_FLOPS["float32"], nbytes)
        # the tensor cores' route: three TF32 products per product
        tc_bound_ms, tc_bound_by = _bound(3 * flops, PEAK_FLOPS["tf32"],
                                          nbytes)
        tflops = flops / kernel_ms / 1e9
        results[name] = dict(max_abs_err=err, err_over_tol=ratio,
                             control_err_over_tol=control_ratio,
                             ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by, tc_bound_ms=tc_bound_ms,
                             tc_bound_by=tc_bound_by, tflops=tflops,
                             design=design)
        say(f"kernel ssd_intra {name} float32 ({design} design): "
            f"max_abs_err={err:.3e} err/tol={ratio:.3f} no-decay control "
            f"err/tol={control_ratio:.3f} (tol {SSD_TOLERANCE}) "
            f"kernel_ms={kernel_ms:.4f} ({tflops:.1f} TFLOP/s) "
            f"plain_ms={plain_ms:.4f} library_ms=none bound_ms="
            f"{bound_ms:.4f} ({bound_by}, fp32 CUDA cores) tc_bound_ms="
            f"{tc_bound_ms:.4f} ({tc_bound_by}, 3xTF32 tensor cores)", card)
        del x, dt, cum, b_in, c_in, args, got, want, control
        torch.cuda.empty_cache()
    return results


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _plain_digests(data, block: int = 1024):
    """``ref.poly_digest_ref`` over a buffer in pieces of whole blocks: the
    same digests (as int32) and total, with the plain version's int64
    temporaries bounded by the piece (64 MB of bytes), not the buffer."""
    import torch

    from repro_torch.kernels import ref
    piece = 1 << 26
    digests = torch.cat([ref.poly_digest_ref(data[i:i + piece], block)[1]
                         .view(torch.int32)
                         for i in range(0, data.numel(), piece)])
    return ref.fold_digests(digests), digests


def phase_checksum_kernel(params, label: str, card: str) -> dict:
    """Every parameter leaf of the model as bytes, all in one launch: the
    kernel's block digests and totals equal the plain version's exactly.
    Control: one byte flipped in the largest leaf changes that leaf's
    total and the digest of exactly one block, at offset // 1024, and no
    other leaf's total or digest."""
    import torch

    from repro_torch.kernels.chunk_checksum import KERNEL

    leaves = [t.reshape(-1).view(torch.uint8) for t in _leaves(params)]
    before = KERNEL.launches
    totals, digests, offsets = KERNEL.many(leaves, 1024)
    if KERNEL.launches != before + 1:
        raise AssertionError(f"chunk_checksum: {KERNEL.launches - before} "
                             f"launches for one list")
    for i, data in enumerate(leaves):
        want_total, want_digests = _plain_digests(data)
        got = digests[offsets[i]:offsets[i + 1]]
        if not (torch.equal(got.view(torch.int32), want_digests) and
                int(totals[i]) == int(want_total)):
            raise AssertionError(f"chunk_checksum: leaf {i} "
                                 f"({data.numel()} bytes) differs from the "
                                 f"plain version")
    big = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    offset = leaves[big].numel() // 3 + 5
    flipped = list(leaves)
    flipped[big] = leaves[big].clone()
    flipped[big][offset] ^= 0x01
    f_totals, f_digests, _ = KERNEL.many(flipped, 1024)
    totals_differ = (f_totals.view(torch.int32) != totals.view(torch.int32)) \
        .nonzero().flatten().tolist()
    differ = (f_digests.view(torch.int32) != digests.view(torch.int32)) \
        .nonzero().flatten().tolist()
    if totals_differ != [big] or differ != [offsets[big] + offset // 1024]:
        raise AssertionError(f"chunk_checksum: flipped byte {offset} of leaf "
                             f"{big} changed totals {totals_differ[:8]}, "
                             f"digests {differ[:8]}")
    del flipped, f_totals, f_digests
    nbytes = sum(t.numel() for t in leaves)
    # the launch alone (its table built once), then with the host's work
    launch = KERNEL.prepare(leaves, 1024)
    kernel_ms = time_ms(lambda: KERNEL.run(launch), 20)
    with_host_ms = time_ms(lambda: KERNEL.many(leaves, 1024), 20)
    plain_ms = time_ms(lambda: [_plain_digests(t) for t in leaves], 2)
    largest = KERNEL.prepare([leaves[big]], 1024)
    largest_ms = time_ms(lambda: KERNEL.run(largest), 50)
    bound_ms, bound_by = _bound(0, 1.0, nbytes)
    say(f"kernel chunk_checksum ({label}): {len(leaves)} leaves, "
        f"{nbytes} bytes "
        f"(bf16 and f32 leaves as uint8, block 1024) in one launch: digests "
        f"and totals equal the plain version exactly; flipped byte {offset} "
        f"of the largest leaf ({leaves[big].numel()} bytes) changed its "
        f"total and only block {offset // 1024}; kernel_ms={kernel_ms:.4f} "
        f"(all leaves, one launch, {nbytes / kernel_ms / 1e9:.3f} TB/s; "
        f"{with_host_ms:.4f} with the host's work of many()) "
        f"largest_leaf_ms={largest_ms:.4f} "
        f"({leaves[big].numel() / largest_ms / 1e9:.3f} TB/s) "
        f"plain_ms={plain_ms:.4f} library_ms=none bound_ms={bound_ms:.4f} "
        f"({bound_by})", card)
    return dict(max_abs_err=0, err_over_tol=0.0, ms=kernel_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, nbytes=nbytes, leaves=len(leaves),
                largest_leaf_ms=largest_ms, with_host_ms=with_host_ms,
                totals=totals.cpu().tolist())


# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class _Routes:
    """Records the routing of every MoE layer the model runs while the
    context is open (``repro_torch.models.moe.route``, as the layer calls
    it)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.routings, self._moe, self._route = [], moe, moe.route

        def recorded(*args):
            self.routings.append(self._route(*args))
            return self.routings[-1]
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def _check_small_model(cfg, label: str, card: str) -> None:
    """The smoke-sized model through the kernels on the card against the
    same weights through the plain path on the CPU: logits and every
    cache leaf within 1e-4, equal greedy outputs and EngineStats.  For an
    MoE model the first 30 of row 0's 40 tokens are token 0, as the engine
    left-pads a wave: the pads route alike and overflow an expert's C =
    25 slots in every layer.  Every layer's routing (expert, slot, kept)
    must be equal on the card and the CPU, and pairs must have dropped."""
    import numpy as np
    import torch

    from repro_torch.models import forward_with_cache, init_lm
    from repro_torch.serve import Request, ServeEngine

    params = init_lm(cfg, seed=0, device="cuda")
    cpu_params = _tree_map(lambda t: t.cpu(), params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    if cfg.num_experts:
        tokens[0, :30] = 0
    with _Routes() as gpu_routes:
        gpu_logits, gpu_cache, _ = forward_with_cache(
            params, torch.as_tensor(tokens, device="cuda"), cfg, max_seq=64)
    with _Routes() as cpu_routes:
        cpu_logits, cpu_cache, _ = forward_with_cache(
            cpu_params, torch.as_tensor(tokens), cfg, max_seq=64)
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    cache_err = max((g[n].cpu().float() - c[n].float()).abs().max().item()
                    for g, c in zip(gpu_cache, cpu_cache) for n in g)
    if not (err <= 1e-4 and cache_err <= 1e-4):
        raise AssertionError(f"small model {label}: card vs CPU logits "
                             f"{err}, cache {cache_err} (tol 1e-4)")
    routing = ""
    if cfg.num_experts:
        dropped = []
        for g, c in zip(gpu_routes.routings, cpu_routes.routings,
                        strict=True):
            for name in ("expert", "slot", "kept"):
                if not torch.equal(getattr(g, name).cpu(), getattr(c, name)):
                    raise AssertionError(f"small model {label}: routing "
                                         f"{name} differs, card vs CPU")
            dropped.append(int((~c.kept).sum()))
        if len(dropped) != cfg.num_layers or not all(dropped):
            raise AssertionError(f"small model {label}: dropped pairs per "
                                 f"layer {dropped}; the pads must overflow")
        routing = (f"; routing (expert, slot, kept) equal in all "
                   f"{len(dropped)} layers, capacity "
                   f"{gpu_routes.routings[0].capacity}, dropped (token, "
                   f"choice) pairs per layer {dropped}")
    outs = []
    for params_, device in ((params, "cuda"), (cpu_params, "cpu")):
        rng = np.random.default_rng(2)
        reqs = [Request(i, rng.integers(1, cfg.vocab_size, 6 + 3 * i),
                        max_new_tokens=6) for i in range(3)]
        eng = ServeEngine(cfg, params_, batch_size=2, max_seq=48,
                          device=device)
        eng.generate(reqs)
        outs.append(([r.output for r in reqs], eng.stats))
    if outs[0] != outs[1]:
        raise AssertionError(f"small model {label}: greedy outputs differ, "
                             f"card {outs[0]} vs CPU {outs[1]}")
    say(f"small model ({label}): card vs CPU max_abs_err logits={err:.3e} "
        f"cache={cache_err:.3e} (tol 1e-4); greedy outputs and stats "
        f"equal{routing}", card)


class _Probe:
    """Times an engine's prefill waves, records their (B, S), times each
    call of one kernel op inside them with CUDA events and records its
    shape, and checks every logit it samples from is finite.  ``timed``
    names more functions, as ``(module, name, flops)``, whose calls it
    times with CUDA events apart in prefill and in decode, with their
    matrix-product FLOPs when ``flops`` is given."""

    def __init__(self, engine, op: str, shape_key, timed=()) -> None:
        from repro_torch.kernels import ops
        self.prefill_s = 0.0
        self.wave_shapes = []
        self.op_events = []
        self.op_shapes = set()
        self._ops, self._op = ops, op
        self._dispatch = getattr(ops, op)
        self._in_prefill = False
        # name → phase → [(start, end, flops)]
        self.timed = {name: {"prefill": [], "decode": []}
                      for _, name, _ in timed}
        self._patches = [(op_module, name, getattr(op_module, name),
                          self._timer(getattr(op_module, name), name, flops))
                         for op_module, name, flops in timed]
        prefill, sample = engine._prefill_batch, engine._sample

        def timed_prefill(prompts):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._in_prefill = True
            try:
                last, cache = prefill(prompts)
            finally:
                self._in_prefill = False
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            self.wave_shapes.append(tuple(prompts.shape))
            return last, cache

        def checked_sample(logits):
            import torch
            if logits.shape[-1] != engine.cfg.vocab_size or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite or misshapen logits "
                                     f"{tuple(logits.shape)}")
            return sample(logits)

        def timed_op(*args, **kw):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._dispatch(*args, **kw)
            end.record()
            self.op_events.append((start, end))
            self.op_shapes.add(shape_key(*args, **kw))
            return out

        engine._prefill_batch = timed_prefill
        engine._sample = checked_sample
        self._timed_op = timed_op

    def _timer(self, fn, name: str, flops):
        def timed(*args, **kw):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.timed[name]["prefill" if self._in_prefill else "decode"] \
                .append((start, end, flops(*args) if flops else 0))
            return out
        return timed

    def __enter__(self):
        setattr(self._ops, self._op, self._timed_op)
        for op_module, name, _, timed in self._patches:
            setattr(op_module, name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._ops, self._op, self._dispatch)
        for op_module, name, fn, _ in self._patches:
            setattr(op_module, name, fn)

    def op_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.op_events)

    def timed_ms(self, name: str, phase: str):
        """(ms, matrix-product FLOPs) of ``name``'s calls in ``phase``."""
        calls = self.timed[name][phase]
        return sum(s.elapsed_time(e) for s, e, _ in calls), \
            sum(f for _, _, f in calls)


def _flash_key(q, k, v, *, causal=True, window=0, softcap=0.0):
    b, s, h, hd = q.shape
    return case_name(Widths(h, k.shape[2], hd, softcap), b, s,
                     window if window < s else 0,
                     str(q.dtype).removeprefix("torch."))


def _ssd_key(x, dt, cum, b_in, c_in):
    b, nc, q, h, p = x.shape
    return ssd_name(b, nc, q, h, p, b_in.shape[-1])


def _drive(name: str, engine, requests, op: str, checked: dict,
           card: str, timed=()) -> None:
    """Serve ``requests`` through ``engine``; ``op`` is the kernel op of
    the path, launched once per layer per prefill wave, at shapes that
    must all be among ``checked``; ``timed`` as ``_Probe`` takes it."""
    import torch
    kernel = _kernels()[op]
    cfg = engine.cfg
    shape_key = _flash_key if op == "flash_attention" else _ssd_key
    torch.cuda.synchronize()
    before = kernel.launches
    t0 = time.perf_counter()
    with _Probe(engine, op, shape_key, timed) as probe:
        engine.generate(requests)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches - before
    st = engine.stats
    waves = len(probe.wave_shapes)
    if launches != cfg.num_layers * waves:
        raise AssertionError(f"engine {name}: {launches} {op} launches for "
                             f"{waves} prefill waves of {cfg.num_layers} "
                             f"layers")
    unchecked = probe.op_shapes - set(checked)
    if unchecked:
        raise AssertionError(f"engine {name}: {op} shapes {unchecked} were "
                             f"not checked against the plain version")
    for r in requests:
        if not (r.done and 1 <= len(r.output) <= r.max_new_tokens and
                all(0 <= t < cfg.vocab_size for t in r.output)):
            raise AssertionError(f"engine {name}: bad request {r.rid}: "
                                 f"{r.output}")
    tokens = sum(len(r.output) for r in requests)
    decode_s = wall - probe.prefill_s
    op_ms = probe.op_ms()
    shares = ""
    for fn in probe.timed:
        wave_ms, flops = probe.timed_ms(fn, "prefill")
        step_ms, _ = probe.timed_ms(fn, "decode")
        rate = f", {flops / wave_ms / 1e9:.1f} TFLOP/s" if flops else ""
        shares += (f"{fn}_ms_per_wave={wave_ms / waves:.2f} ("
                   f"{100 * wave_ms / (1e3 * probe.prefill_s):.1f}% of "
                   f"prefill{rate}) {fn}_ms_per_decode_step="
                   f"{step_ms / max(st.decode_steps, 1):.2f} ("
                   f"{100 * step_ms / max(1e3 * decode_s, 1e-9):.1f}% of "
                   f"decode) ")
    say(f"engine {name}: prefills={st.prefills} waves={waves} "
        f"wave_shapes={probe.wave_shapes} "
        f"{op}_shapes={sorted(probe.op_shapes)} "
        f"decode_steps={st.decode_steps} tokens_out={st.tokens_out} "
        f"{op}_launches={launches} "
        f"ms_per_prefill_wave={1e3 * probe.prefill_s / waves:.2f} "
        f"{op}_ms_per_wave={op_ms / waves:.2f} (CUDA events, "
        f"{100 * op_ms / (1e3 * probe.prefill_s):.1f}% of prefill) "
        f"{shares}ms_per_decode_step="
        f"{1e3 * decode_s / max(st.decode_steps, 1):.2f} "
        f"tokens_per_s={tokens / wall:.2f} wall_s={wall:.2f} "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)


def _describe(cfg, params, t0: float, card: str) -> None:
    import torch
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"{cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"vocab={cfg.vocab_size} params={n_params} ({cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated) "
        f"init_s={time.perf_counter() - t0:.1f}", card)


def phase_serve_gemma(card: str, checked: dict) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeEngine

    _check_small_model(
        dataclasses.replace(get_config("gemma2-2b", smoke=True),
                            dtype="float32", padded_heads=8),
        "gemma2-2b smoke, f32, 8 padded heads", card)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0, card)

    engine_a = ServeEngine(cfg, params, batch_size=ENGINE_A_BATCH,
                           max_seq=512)
    engine_b = ServeEngine(cfg, params, batch_size=1, max_seq=4608)
    rng = np.random.default_rng(0)
    reqs_a = [Request(i, rng.integers(0, cfg.vocab_size, int(n)),
                      max_new_tokens=32)
              for i, n in enumerate(engine_a_lengths(rng))]
    reqs_b = [Request(100, rng.integers(0, cfg.vocab_size, 4352),
                      max_new_tokens=8)]
    # warm-up (cuBLAS handles, allocator), outside the counted run
    ServeEngine(cfg, params, batch_size=4, max_seq=512).generate(
        [Request(-1, rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)])

    _reset_counts()                          # the gemma2 path starts here
    _drive("A (batch 4, max_seq 512, 8 prompts of 64-256)", engine_a,
           reqs_a, "flash_attention", checked, card)
    _drive("B (batch 1, max_seq 4608, one prompt of 4352)", engine_b,
           reqs_b, "flash_attention", checked, card)
    flash = _kernels()["flash_attention"]              # ... and ends here
    launches, by_design = flash.launches, dict(flash.launches_by_design)
    say(f"serve gemma2-2b: flash launches {launches} by design "
        f"{by_design}, max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    if not launches:
        raise AssertionError("the gemma2 path launched no flash kernel")
    if by_design["wgmma"] != launches:
        raise AssertionError(f"the gemma2 path sent flash launches to other "
                             f"designs than wgmma: {by_design}")
    return launches


def phase_serve_mamba(card: str, checked: dict):
    """Returns (ssd_intra launches, chunk_checksum launches, the checksum
    kernel's check) of the mamba2 path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, param_checksums
    from repro_torch.serve import Request, ServeEngine

    _check_small_model(
        dataclasses.replace(get_config("mamba2-780m", smoke=True),
                            dtype="float32"),
        "mamba2-780m smoke, f32", card)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0, card)
    checksum = phase_checksum_kernel(params, "mamba2-780m", card)

    engine_c = ServeEngine(cfg, params, batch_size=ENGINE_C_BATCH,
                           max_seq=1088)
    engine_d = ServeEngine(cfg, params, batch_size=1, max_seq=8192)
    rng = np.random.default_rng(0)
    reqs_c = [Request(i, rng.integers(0, cfg.vocab_size, int(n)),
                      max_new_tokens=32)
              for i, n in enumerate(engine_c_lengths(rng))]
    reqs_d = [Request(100, rng.integers(0, cfg.vocab_size, ENGINE_D_PROMPT),
                      max_new_tokens=8)]
    ServeEngine(cfg, params, batch_size=4, max_seq=512).generate(
        [Request(-1, rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)])

    _reset_counts()                          # the mamba2 path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = param_checksums(params)
    torch.cuda.synchronize()
    sums_ms = 1e3 * (time.perf_counter() - t0)
    sums_launches = _kernels()["chunk_checksum"].launches
    if len(sums) != checksum["leaves"] or sums_launches != 1:
        raise AssertionError(f"param_checksums: {len(sums)} leaves of "
                             f"{checksum['leaves']} in {sums_launches} "
                             f"launches, not 1")
    if [int(t) for t in sums.values()] != checksum["totals"]:
        raise AssertionError("param_checksums differs from the checked "
                             "totals of the same leaves")
    checksum["host_ms"] = sums_ms
    say(f"serve mamba2-780m: param_checksums over {len(sums)} leaves in "
        f"{sums_launches} launch, {sums_ms:.2f} ms (host clock; e.g. "
        f"embed.embedding {int(sums['embed.embedding']):#010x})", card)
    _drive("C (batch 4, max_seq 1088, 8 prompts of 64-1000)", engine_c,
           reqs_c, "ssd_intra", checked, card)
    _drive(f"D (batch 1, max_seq 8192, one prompt of {ENGINE_D_PROMPT})",
           engine_d, reqs_d, "ssd_intra", checked, card)
    kernels = _kernels()                     # ... and ends here
    ssd_kernel = kernels["ssd_intra"]
    ssd, by_design = ssd_kernel.launches, dict(ssd_kernel.launches_by_design)
    sums_launches = kernels["chunk_checksum"].launches
    say(f"serve mamba2-780m: ssd_intra launches {ssd} by design "
        f"{by_design}, chunk_checksum launches {sums_launches}, "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    if not (ssd and sums_launches == 1):
        raise AssertionError(f"the mamba2 path launched ssd_intra {ssd} and "
                             f"chunk_checksum {sums_launches} times")
    if by_design["wgmma"] != ssd:
        raise AssertionError(f"the mamba2 path sent ssd_intra launches to "
                             f"other designs than wgmma: {by_design}")
    return ssd, sums_launches, checksum


def _expert_flops(p, xe) -> int:
    """The three expert products of ``moe.expert_ffn`` on xe (E, N, D)."""
    return 3 * 2 * xe.numel() * p["w1"].shape[-1]


def phase_serve_mixtral(card: str, checked: dict):
    """Returns (flash launches, chunk_checksum launches, the checksum
    kernel's check) of the mixtral path.  The depth is cut from 56 to
    ``MIXTRAL_LAYERS`` layers, so that the bf16 weights fit one card with
    room for the engines; every width is the published one."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, moe, param_checksums
    from repro_torch.serve import Request, ServeEngine

    _check_small_model(
        dataclasses.replace(get_config("mixtral-8x22b", smoke=True),
                            dtype="float32"),
        "mixtral-8x22b smoke, f32", card)
    torch.cuda.reset_peak_memory_stats()
    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0, card)
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    say(f"mixtral-8x22b cut: {cfg.num_layers} of {full.num_layers} layers "
        f"(depth only); d={cfg.d_model}, {cfg.num_heads} q-heads over "
        f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, "
        f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}, "
        f"window {cfg.sliding_window}, vocab {cfg.vocab_size}; weights "
        f"{weight_bytes} bytes", card)
    checksum = phase_checksum_kernel(params, "mixtral-8x22b", card)

    engine_e = ServeEngine(cfg, params, batch_size=ENGINE_A_BATCH,
                           max_seq=512)
    engine_f = ServeEngine(cfg, params, batch_size=1, max_seq=4608)
    rng = np.random.default_rng(0)
    reqs_e = [Request(i, rng.integers(0, cfg.vocab_size, int(n)),
                      max_new_tokens=32)
              for i, n in enumerate(engine_a_lengths(rng))]
    reqs_f = [Request(100, rng.integers(0, cfg.vocab_size, ENGINE_F_PROMPT),
                      max_new_tokens=8)]
    ServeEngine(cfg, params, batch_size=4, max_seq=512).generate(
        [Request(-1, rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)])

    _reset_counts()                          # the mixtral path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = param_checksums(params)
    torch.cuda.synchronize()
    sums_ms = 1e3 * (time.perf_counter() - t0)
    sums_launches = _kernels()["chunk_checksum"].launches
    if len(sums) != checksum["leaves"] or sums_launches != 1:
        raise AssertionError(f"param_checksums: {len(sums)} leaves of "
                             f"{checksum['leaves']} in {sums_launches} "
                             f"launches, not 1")
    if [int(t) for t in sums.values()] != checksum["totals"]:
        raise AssertionError("param_checksums differs from the checked "
                             "totals of the same leaves")
    checksum["host_ms"] = sums_ms
    say(f"serve mixtral-8x22b: param_checksums over {len(sums)} leaves in "
        f"{sums_launches} launch, {sums_ms:.2f} ms (host clock)", card)
    timed = ((moe, "moe_forward", None), (moe, "route", None),
             (moe, "expert_ffn", _expert_flops))
    _drive("E (batch 4, max_seq 512, 8 prompts of 64-256)", engine_e,
           reqs_e, "flash_attention", checked, card, timed)
    _drive(f"F (batch 1, max_seq 4608, one prompt of {ENGINE_F_PROMPT})",
           engine_f, reqs_f, "flash_attention", checked, card, timed)
    kernels = _kernels()                     # ... and ends here
    flash = kernels["flash_attention"]
    launches, by_design = flash.launches, dict(flash.launches_by_design)
    sums_launches = kernels["chunk_checksum"].launches
    slots = cfg.num_experts * moe.capacity(cfg, ENGINE_F_PROMPT)
    expert_bound_ms, _ = _bound(
        cfg.num_layers * 3 * 2 * slots * cfg.d_model * cfg.d_ff,
        PEAK_FLOPS["bfloat16"], 0)
    decode_bound_ms, _ = _bound(0, 1.0, weight_bytes)
    say(f"serve mixtral-8x22b: flash launches {launches} by design "
        f"{by_design}, chunk_checksum launches {sums_launches}, "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; bounds: "
        f"engine F's expert products ({slots} slots x {cfg.d_model} x "
        f"{cfg.d_ff}, 3 products, {cfg.num_layers} layers) "
        f"{expert_bound_ms:.2f} ms a wave at 989 TFLOP/s; a decode step "
        f"reading every weight once {decode_bound_ms:.2f} ms at 3.35 TB/s",
        card)
    if not (launches and sums_launches == 1):
        raise AssertionError(f"the mixtral path launched flash {launches} "
                             f"and chunk_checksum {sums_launches} times")
    if by_design["wgmma"] != launches:
        raise AssertionError(f"the mixtral path sent flash launches to "
                             f"other designs than wgmma: {by_design}")
    return launches, sums_launches, checksum


# ---------------------------------------------------------------------------
# The federation: the paper's protocol (G) and a fleet restart storm (H)
# ---------------------------------------------------------------------------
PAPER_PHASES = ("proxy_cold", "proxy_warm", "stash_cold", "stash_warm")
STORM_PODS, STORM_HOSTS = 250, 4         # FederationSpec.fleet(250, 4)
# the reference's counts for storm H (JAX, solver "vector", on a CPU)
STORM_WANT = {"requests": 1000, "cache_hits": 60_000,
              "cache_misses": 20_000, "origin_egress_bytes": 500 * 10**9}
STORM_MIN_SOLVES = 500
SOLVER_RTOL = 1e-4                       # vector vs scalar seconds
MAXMIN_REF_RTOL, MAXMIN_REF_ATOL = 2e-3, 1e3   # tests/test_maxmin.py's
MAXMIN_CPU_RTOL = 1e-6


def phase_federation_paper(card: str) -> None:
    """G: the paper's §4.1 protocol.  At every OSG site, each evaluation
    file goes through four sequential fetches (proxy cold, proxy warm,
    stash cold, stash warm) on the simulated engine on the card, against
    a fresh federation; solver "auto", as the paper's benchmark runs it
    (one flow at a time stays below its threshold: the host's scalar
    solver), and again "vector" (every solve on the card), which must
    give equal counters and seconds within 1e-4.  The "vector" runs on
    the card must equal the same runs on the CPU byte for byte."""
    import dataclasses as dc

    import repro_torch.core as core
    from repro_torch.analysis.sanitize import (canonical_report_bytes,
                                               close_reports)
    from repro_torch.kernels import maxmin

    t0 = time.perf_counter()
    maxmin.COUNTS.reset()
    rows = []
    for site in core.PAPER_TABLE3:
        for path, size in core.evaluation_fileset():
            def spec(device, solver="auto"):
                return core.ScenarioSpec(
                    name=f"proxy_vs_stash/{site}",
                    federation=core.FederationSpec.osg(),
                    workload=[core.FetchRequest(path, site=site,
                                                method=ph.split("_")[0],
                                                size=size)
                              for ph in PAPER_PHASES],
                    sequential=True, engine="sim", solver=solver,
                    device=device)
            rep = core.run_scenario(spec("cuda"))
            vector = core.run_scenario(spec("cuda", "vector"))
            if canonical_report_bytes(vector) != canonical_report_bytes(
                    core.run_scenario(spec("cpu", "vector"))):
                raise AssertionError(f"G {site} {path}: the card's report "
                                     f"differs from the CPU's")
            close_reports(dc.asdict(vector), dc.asdict(rep), SOLVER_RTOL,
                          f"G {site} {path}")
            row = {"site": site, "path": path, "size": size}
            for phase, r in zip(PAPER_PHASES, rep.results):
                if not (r.ok and r.seconds > 0):
                    raise AssertionError(f"G {site} {path} {phase}: {r}")
                row[phase] = r.seconds
            if not rep.results[3].cache_hit:
                raise AssertionError(f"G {site} {path}: warm stash missed")
            rows.append(row)
    seconds = time.perf_counter() - t0
    say(f"G (paper §4.1, {len(core.PAPER_TABLE3)} OSG sites x "
        f"{len(core.evaluation_fileset())} files x 4 fetches, engine sim "
        f"on cuda, solver auto; solver vector within {SOLVER_RTOL} of it "
        f"and equal to its CPU run byte for byte): {seconds:.2f} s, "
        f"{maxmin.COUNTS.solves_by_device.get('cuda', 0)} vector solves "
        f"on cuda", card)
    for row in rows:
        say(f"G {row['site']:<10} {row['path']:<24} " + ", ".join(
            f"{ph} {row['size'] / row[ph] / 1e6:.2f} MB/s"
            for ph in PAPER_PHASES), card)
    agree = 0
    for row in rows:
        label = ("2.3GB" if "p95" in row["path"]
                 else "10GB" if "10gb" in row["path"] else None)
        if label is None:
            continue
        proxy = (row["proxy_cold"] + row["proxy_warm"]) / 2
        stash = (row["stash_cold"] + row["stash_warm"]) / 2
        ours = 100.0 * (stash - proxy) / proxy
        paper = core.PAPER_TABLE3[row["site"]][label]
        agree += (ours < 0) == (paper < 0)
        say(f"G Table 3 {row['site']:<10} {label:<5} StashCache vs proxy "
            f"{ours:+.1f}% (paper {paper:+.1f}%)", card)
    say(f"G Table 3: the sign agrees with the paper in {agree} of "
        f"{2 * len(core.PAPER_TABLE3)} cells", card)


def _storm_spec(core, solver: str, device: str, pods: int = STORM_PODS):
    return core.ScenarioSpec(
        name=f"restart-storm/{pods}x{STORM_HOSTS}",
        federation=core.FederationSpec.fleet(num_pods=pods,
                                             hosts_per_pod=STORM_HOSTS),
        workload=core.WorkloadSpec(kind="storm", size=2 * 10**9,
                                   workers_per_site=STORM_HOSTS,
                                   jitter=2.0),
        solver=solver, device=device)


def _scalar_rates(link_caps, flow_links, flow_caps):
    """The simulator's scalar solver on one problem: (rates, seconds)."""
    import types

    from repro_torch.core import FluidFlowSim, Topology
    from repro_torch.core.simulator import Flow
    links = [types.SimpleNamespace(bandwidth=c) for c in link_caps]
    sim = FluidFlowSim(Topology(), solver="scalar", device="cpu")
    sim.active = [Flow("s", "d", 1.0, 1, [links[i] for i in row], cap)
                  for row, cap in zip(flow_links, flow_caps)]
    t0 = time.perf_counter()
    sim._reallocate_scalar()
    return [f.rate for f in sim.active], time.perf_counter() - t0


def _snapshot(problem, card: str, label: str) -> dict:
    """Check 3 at one recorded solve: the card's rates against the float64
    oracle (rtol 2e-3, atol 1e3) and against the same ops on the CPU
    (1e-6 relative), each with a control (the most-shared saturated
    link's capacity halved) that must fail it; then the times."""
    import numpy as np
    import torch

    from repro_torch.kernels import maxmin
    from repro_torch.kernels.ref import maxmin_ref

    link_caps, flow_links, flow_caps = problem
    F, L = len(flow_links), len(link_caps)
    maxmin.COUNTS.reset()
    card_rates = maxmin.maxmin_rates_sparse(link_caps, flow_links,
                                            flow_caps, device="cuda")
    rounds = maxmin.COUNTS.rounds
    cpu_rates = maxmin.maxmin_rates_sparse(link_caps, flow_links, flow_caps,
                                           device="cpu")
    mem = np.zeros((F, L), bool)
    for f, row in enumerate(flow_links):
        mem[f, row] = True
    oracle = maxmin_ref(link_caps, mem, flow_caps)
    load = mem.T.astype(np.float64) @ oracle
    saturated = np.flatnonzero(load >= 0.999 * np.asarray(link_caps))
    if not saturated.size:
        raise AssertionError(f"H snapshot {label}: no saturated link to "
                             f"halve for the control")
    halve = saturated[np.argmax(mem[:, saturated].sum(0))]
    halved = list(link_caps)
    halved[halve] /= 2
    oracle_ctl = maxmin_ref(halved, mem, flow_caps)
    cpu_ctl = maxmin.maxmin_rates_sparse(halved, flow_links, flow_caps,
                                         device="cpu")

    def ok_ref(want):
        return np.allclose(card_rates, want, rtol=MAXMIN_REF_RTOL,
                           atol=MAXMIN_REF_ATOL)

    def ok_cpu(want):
        return np.allclose(card_rates, want, rtol=MAXMIN_CPU_RTOL, atol=0)
    if not (ok_ref(oracle) and ok_cpu(cpu_rates)):
        raise AssertionError(f"H snapshot {label}: the card's rates miss "
                             f"the oracle or the CPU run")
    if ok_ref(oracle_ctl) or ok_cpu(cpu_ctl):
        raise AssertionError(f"H snapshot {label}: a control passed (link "
                             f"{halve} halved)")
    rel_cpu = float(np.max(np.abs(card_rates - cpu_rates)
                           / np.maximum(np.abs(cpu_rates), 1e-30)))
    rel_ref = float(np.max(np.abs(card_rates - oracle)
                           / np.maximum(np.abs(oracle), 1e-30)))
    scalar_rates, _ = _scalar_rates(link_caps, flow_links, flow_caps)
    if not np.allclose(card_rates, scalar_rates, rtol=MAXMIN_REF_RTOL,
                       atol=MAXMIN_REF_ATOL):
        raise AssertionError(f"H snapshot {label}: card vs scalar solver")

    # times: the device loop alone (inputs resident; CUDA events), the
    # whole call as the simulator pays it (host clock), the same ops on
    # the CPU, and the scalar solver
    width = maxmin._next_pow2(max(len(r) for r in flow_links), floor=4)
    padded = maxmin.pad_problem(link_caps, flow_links, flow_caps,
                                maxmin._next_pow2(F),
                                maxmin._next_pow2(L + 1), width)
    args = maxmin.device_problem(*padded, torch.device("cuda"))
    loop_ms = time_ms(lambda: maxmin.solve_waterfill(*args), 50)

    def host_ms(fn, iters):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    call_ms = host_ms(lambda: maxmin.maxmin_rates_sparse(
        link_caps, flow_links, flow_caps, device="cuda"), 50)
    cpu_ms = host_ms(lambda: maxmin.maxmin_rates_sparse(
        link_caps, flow_links, flow_caps, device="cpu"), 20)
    scalar_ms = min(1e3 * _scalar_rates(link_caps, flow_links, flow_caps)[1]
                    for _ in range(5))
    # the least the solve must move: the whole problem fits in one SM's
    # shared memory, so each input is read once and the rates written
    # once: the flows' link indices (int32), the flow caps, the link
    # caps and the rates (float32).  The floor that binds is the
    # launches and host reads of ``rounds`` rounds, not these bytes.
    table = args[3]
    nnz = sum(len(r) for r in flow_links)
    solve_bytes = 4 * nnz + 4 * F + 4 * L + 4 * F
    bound_ms = 1e3 * solve_bytes / HBM_BYTES_PER_S
    out = {"flows": F, "links": L, "memberships": nnz,
           "padded": [len(padded[2]), len(padded[0]), width],
           "table_degree": int(table.shape[1]), "rounds": rounds,
           "max_abs_err": float(np.max(np.abs(card_rates - cpu_rates))),
           "max_rel_err_cpu": rel_cpu, "max_rel_err_oracle": rel_ref,
           "ms": loop_ms, "host_ms": call_ms, "plain_ms": cpu_ms,
           "scalar_ms": scalar_ms, "bytes": solve_bytes,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
           "control_link": int(halve)}
    say(f"H snapshot {label}: {F} flows over {L} links (padded "
        f"{out['padded']}), {rounds} rounds; card vs oracle max rel "
        f"{rel_ref:.2e} (tol {MAXMIN_REF_RTOL} + {MAXMIN_REF_ATOL:g}), vs "
        f"CPU ops {rel_cpu:.2e} (tol {MAXMIN_CPU_RTOL}); controls (link "
        f"{halve}, {int(mem[:, halve].sum())} flows, halved) fail both; "
        f"device loop {loop_ms:.4f} ms (CUDA events), whole call "
        f"{call_ms:.4f} ms (host clock), same ops on the CPU "
        f"{cpu_ms:.4f} ms, scalar solver {scalar_ms:.4f} ms; bound "
        f"{bound_ms:.6f} ms ({solve_bytes} B once at 3.35 TB/s)", card)
    return out


def phase_federation_storm(card: str) -> dict:
    """H: a fleet restart storm (250 pods of 4 hosts, every worker pulls a
    2 GB checkpoint within 2 s) on the simulated engine with every solve
    on the card.  Returns the solver's numbers for the kernels line."""
    import dataclasses as dc
    import statistics

    import repro_torch.core as core
    from repro_torch.analysis.sanitize import (canonical_report_bytes,
                                               close_reports)
    from repro_torch.kernels import maxmin

    core.run_scenario(_storm_spec(core, "vector", "cuda", pods=4))  # warm
    counts = maxmin.COUNTS
    counts.reset()                           # the storm's path starts here
    t0 = time.perf_counter()
    rep = core.run_scenario(_storm_spec(core, "vector", "cuda"))
    wall = time.perf_counter() - t0
    run = dc.replace(counts, solves_by_device=dict(
        counts.solves_by_device))           # ... and ends here
    solves = run.solves_by_device.get("cuda", 0)
    got = {"requests": len(rep.results), "cache_hits": rep.cache_hits,
           "cache_misses": rep.cache_misses,
           "origin_egress_bytes": rep.origin_egress_bytes}
    if got != STORM_WANT or not all(r.ok for r in rep.results):
        raise AssertionError(f"H: counters {got}, the reference's "
                             f"{STORM_WANT}")
    if solves < STORM_MIN_SOLVES or solves != run.solves or \
            solves != rep.reallocations:
        raise AssertionError(f"H: {solves} vector solves on cuda of "
                             f"{run.solves} ({rep.reallocations} "
                             f"reallocations); at least "
                             f"{STORM_MIN_SOLVES} must run on the card")
    say(f"H (fleet {STORM_PODS} pods x {STORM_HOSTS} hosts, storm of "
        f"{len(rep.results)} requests for 2 GB, jitter 2 s, solver vector "
        f"on cuda): {wall:.2f} s wall, sim {rep.sim_seconds:.3f} s; hits "
        f"{rep.cache_hits}, misses {rep.cache_misses}, evictions "
        f"{rep.evictions}, origin egress {rep.origin_egress_bytes} B, "
        f"bytes moved {rep.bytes_moved}", card)
    # check 2: a second run, byte for byte; it also records the problems
    recorded = []
    solve = maxmin.maxmin_rates_sparse

    def recorder(link_caps, flow_links, flow_caps, device=None):
        recorded.append((list(link_caps), [list(r) for r in flow_links],
                         list(flow_caps)))
        return solve(link_caps, flow_links, flow_caps, device=device)
    maxmin.maxmin_rates_sparse = recorder
    try:
        again = core.run_scenario(_storm_spec(core, "vector", "cuda"))
    finally:
        maxmin.maxmin_rates_sparse = solve
    if canonical_report_bytes(again) != canonical_report_bytes(rep):
        raise AssertionError("H: two vector runs on cuda differ")
    sizes = [len(p[1]) for p in recorded]
    say(f"H solver: {solves} solves on cuda; flows per solve median "
        f"{statistics.median(sizes):.0f}, largest {max(sizes)} (the "
        f"replay's); rounds per solve {run.rounds / solves:.3f}; host "
        f"syncs {run.syncs / solves:.3f} and copies {run.h2d / solves:.3f}"
        f" host->device, {run.d2h / solves:.3f} device->host per solve; "
        f"{1e3 * run.host_seconds / solves:.4f} ms per solve (host clock, "
        f"whole call), {run.host_seconds:.3f} s in solves = "
        f"{100 * run.host_seconds / wall:.1f}% of the wall time", card)
    # check 1: the scalar solver, counters equal, seconds within 1e-4
    t0 = time.perf_counter()
    scalar = core.run_scenario(_storm_spec(core, "scalar", "cuda"))
    scalar_wall = time.perf_counter() - t0
    close_reports(dc.asdict(rep), dc.asdict(scalar), SOLVER_RTOL, "H")
    say(f"H checks: the replay's {len(canonical_report_bytes(rep))} "
        f"report bytes are identical; solver scalar ({scalar_wall:.2f} s "
        f"wall) gives equal counters, seconds within {SOLVER_RTOL}", card)
    # check 3 at three snapshots, the peak among them
    picks = {"peak": sizes.index(max(sizes)), "quarter": len(sizes) // 4,
             "three-quarters": 3 * len(sizes) // 4}
    snaps = {label: _snapshot(recorded[i], card, f"{label} (solve {i})")
             for label, i in picks.items()}
    for label in snaps:
        snaps[label]["solve_index"] = picks[label]
    return {"launches": solves, "solves": solves, "wall_s": wall,
            "solve_host_s": run.host_seconds,
            "flows_median": statistics.median(sizes),
            "flows_max": max(sizes), "rounds": run.rounds,
            "syncs": run.syncs, "h2d": run.h2d, "d2h": run.d2h,
            "scalar_wall_s": scalar_wall, "snapshots": snaps}


# ---------------------------------------------------------------------------
def _entry(name: str, launches: int, case: dict, tolerance: str,
           shape: str, card: str) -> dict:
    source, replaces = KERNEL_FILES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"],
            "err_over_tol": case["err_over_tol"], "tolerance": tolerance,
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "shape": shape, "card": card,
            **{k: case[k] for k in ("design", "tflops", "tc_bound_ms",
                                    "tc_bound_by", "host_ms",
                                    "with_host_ms", "largest_leaf_ms")
                   if k in case}}


def _case(case: dict, shape: str, **extra) -> dict:
    """A second measured case of a kernel, beside its main one."""
    return {"shape": shape, **extra,
            **{k: case[k] for k in ("max_abs_err", "err_over_tol", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "design", "tflops",
                                    "host_ms", "with_host_ms",
                                    "largest_leaf_ms") if k in case}}


def _maxmin_entry(storm: dict, card: str) -> dict:
    """The max-min solver's line: torch ops, not a hand kernel; its main
    case is storm H's peak solve."""
    peak = storm["snapshots"]["peak"]
    return {"name": "maxmin", "route": "torch",
            "source": "src/repro_torch/kernels/maxmin.py",
            "replaces": "src/repro/kernels/maxmin.py:36",
            "launches": storm["launches"],
            **{k: peak[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "host_ms", "scalar_ms",
                                    "max_rel_err_oracle", "rounds")},
            "tolerance": f"card vs the same ops on the CPU "
                         f"{MAXMIN_CPU_RTOL} relative; vs maxmin_ref rtol "
                         f"{MAXMIN_REF_RTOL}, atol {MAXMIN_REF_ATOL:g}",
            "shape": f"storm H's peak solve: {peak['flows']} flows, "
                     f"{peak['links']} links, padded {peak['padded']}",
            "card": card,
            "storm": {k: v for k, v in storm.items() if k != "snapshots"},
            "snapshots": storm["snapshots"]}


def _free() -> None:
    """Release the last path's weights: its engines hold them in reference
    cycles (the probes' wrappers), which only the collector breaks."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    t_start = time.perf_counter()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase_build(card)
    flash = phase_flash_kernel(card)
    ssd = phase_ssd_kernel(card)
    gemma_flash = phase_serve_gemma(card, flash)
    _free()
    ssd_launches, mamba_sums, checksum = phase_serve_mamba(card, ssd)
    _free()
    mixtral_flash, mixtral_sums, mixtral_checksum = phase_serve_mixtral(
        card, flash)
    _free()
    phase_federation_paper(card)
    storm = phase_federation_storm(card)
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s", card)
    # launches: the sum over the paths that run the kernel
    flash_entry = _entry("flash_attention", gemma_flash + mixtral_flash,
                         flash[MAIN_CASE], TOLERANCE["bfloat16"], MAIN_CASE,
                         card)
    flash_entry["launches_by_path"] = {"gemma2-2b": gemma_flash,
                                       "mixtral-8x22b": mixtral_flash}
    flash_entry["hd128_case"] = _case(flash[MAIN_CASE_128], MAIN_CASE_128,
                                      launches=mixtral_flash)
    checksum_entry = _entry(
        "chunk_checksum", mamba_sums + mixtral_sums, checksum, "exact",
        f"{checksum['leaves']} leaves of mamba2-780m, "
        f"{checksum['nbytes']} bytes as uint8, block 1024", card)
    checksum_entry["launches_by_path"] = {"mamba2-780m": mamba_sums,
                                          "mixtral-8x22b": mixtral_sums}
    checksum_entry["mixtral_case"] = _case(
        mixtral_checksum, f"{mixtral_checksum['leaves']} leaves of "
        f"mixtral-8x22b ({MIXTRAL_LAYERS} layers), "
        f"{mixtral_checksum['nbytes']} bytes as uint8, block 1024",
        launches=mixtral_sums)
    print(json.dumps({"kernels": [
        flash_entry,
        _entry("ssd_intra", ssd_launches, ssd[SSD_MAIN_CASE], SSD_TOLERANCE,
               f"{SSD_MAIN_CASE} float32", card),
        checksum_entry,
        _maxmin_entry(storm, card),
    ]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
