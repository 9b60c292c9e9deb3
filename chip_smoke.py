#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving paths on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX.  Every phase raises on a mismatch, so the exit code is non-zero if
any phase fails:

1. build   — compile the three kernels from ``src/repro_torch`` (one
             ``nvcc`` each, all started together) and print what
             ``nvcc -Xptxas -v`` reports for them;
2. kernel  — each kernel against its plain PyTorch version:
             flash attention at gemma2-2b's widths and every (B, S) the
             gemma2 engines give it, with a softcap-off control;
             ssd_intra at mamba2-780m's widths and every (B, NC, Q) the
             mamba2 engines give it, and at the smoke widths, with a
             no-decay control; kernel, plain, library and bound times;
3. serve   — gemma2-2b: a small model on the card against the same model
             on the CPU, then full width (random weights from seed 0) in
             engines A (short prompts, batch 4) and B (one 4352-token
             prompt through the sliding window);
             mamba2-780m: the chunk checksum over every parameter leaf,
             exactly equal to its plain version, with a flipped-byte
             control; a small model card-vs-CPU check; then full width
             (random weights from seed 0): the leaves' checksums and
             engines C (8 prompts of 64-1000 tokens, batch 4) and D (one
             8000-token prompt, 32 chunks);
4. report  — one JSON line of kernel numbers, then the device line.

Each serving path runs with every launch count set to 0 just before it
and read just after.  Every line with a measured number names the card
and its power limit.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H, KV, HD, SOFTCAP = 16, 4, 256, 50.0      # gemma2-2b attention
# q at 4x unit scale gives scores of std 4, where the softcap bends the
# top scores (50·tanh(16/50) is 15.47); the model's own q and k are larger
Q_SCALE = 4.0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOLERANCE = {"bfloat16": "2^-7·|want| + 1e-3 (one bf16 ulp)",
             "float32": "1e-4"}
SSD_RTOL = 1e-4
SSD_TOLERANCE = "1e-4 + 1e-4·|want|"
ENGINE_A_BATCH = 4
ENGINE_C_BATCH = 4
ENGINE_D_PROMPT = 8000
MAIN_CASE = "B1 S4352 window4096 bfloat16"   # engine B's windowed layers
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
    """(B, S, window, dtype): every shape the serve phase gives the flash
    kernel in bf16 (engine A's two waves, engine B's windowed and global
    layers), then edge cases."""
    import numpy as np
    waves = _wave_lengths(engine_a_lengths(np.random.default_rng(0)),
                          ENGINE_A_BATCH)
    return [
        *[(ENGINE_A_BATCH, s, 0, "bfloat16") for s in waves],
        (1, 4352, 4096, "bfloat16"),
        (1, 4352, 0, "bfloat16"),
        (1, 1024, 0, "bfloat16"),
        (1, 1024, 0, "float32"),
        (1, 96, 0, "bfloat16"),            # ragged
        (1, 96, 0, "float32"),
        (1, 512, 64, "bfloat16"),
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


def case_name(b: int, s: int, window: int, dtype: str) -> str:
    band = f"window{window}" if window else "causal"
    return f"B{b} S{s} {band} {dtype}"


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
    for lib in libs:
        for line in lib.ptxas_report.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                say(f"ptxas {lib.name}: {line.split(':', 1)[-1].strip()}",
                    card)
    say("dynamic shared memory per block: " + ", ".join(
        f"flash hd {hd}: {fa.KERNEL.smem_bytes(hd)} B" for hd in fa.HEAD_DIMS)
        + ", " + ", ".join(f"ssd_intra (P {p}, N {n}): "
                           f"{ssd_scan.KERNEL.smem_bytes(p, n)} B"
                           for p, n in ssd_scan.SHAPES), card)


def _bound(flops: float, peak: float, nbytes: int):
    """Least time for the work: the larger of its operations over the
    type's peak and its bytes (each input read once, each output written
    once) over HBM."""
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _flash_bound(b: int, s: int, window: int, dtype: str, nbytes: int):
    """Matrix-product FLOPs of the valid (row, column) pairs only."""
    pairs = sum(r - (max(0, r - window + 1) if window else 0) + 1
                for r in range(s))
    return _bound(4 * b * H * HD * pairs, PEAK_FLOPS[dtype], nbytes)


def phase_flash_kernel(card: str) -> dict:
    """Each case: the kernel against the plain version within the stated
    tolerance, and a control (the kernel with the softcap off, against the
    plain version with it on) that must fall outside it, so the check is
    known to see the softcap."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import KERNEL

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, window, dtype_name in kernel_cases():
        dtype = getattr(torch, dtype_name)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device="cuda")
                    ).to(dtype)
        q, k, v = rand(b, s, H, HD, scale=Q_SCALE), rand(b, s, KV, HD), \
            rand(b, s, KV, HD)
        kw = dict(causal=True, window=window, softcap=SOFTCAP)
        got = KERNEL(q, k, v, **kw)
        control = KERNEL(q, k, v, causal=True, window=window, softcap=0.0)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        name = case_name(b, s, window, dtype_name)
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
            raise AssertionError(f"kernel {name}: the softcap-off control is "
                                 f"within tolerance ({control_ratio}); the "
                                 f"check cannot see the softcap")
        iters = max(20, min(200, int(2e10 // (b * s * s * H * HD))))
        kernel_ms = time_ms(lambda: KERNEL(q, k, v, **kw), iters)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                           max(2, iters // 4))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
        nbytes = 2 * (q.nbytes + k.nbytes)           # q, k, v, o
        bound_ms, bound_by = _flash_bound(b, s, window, dtype_name, nbytes)
        results[name] = dict(max_abs_err=err, err_over_tol=ratio,
                             control_err_over_tol=control_ratio,
                             ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        say(f"kernel flash {name}: max_abs_err={err:.3e} err/tol={ratio:.3f} "
            f"softcap-off control err/tol={control_ratio:.3f} (tol {tol}) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (sdpa causal, softcap 0) "
            f"bound_ms={bound_ms:.4f} ({bound_by})", card)
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
        got = KERNEL(*args)
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
        results[name] = dict(max_abs_err=err, err_over_tol=ratio,
                             control_err_over_tol=control_ratio,
                             ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by)
        say(f"kernel ssd_intra {name} float32: max_abs_err={err:.3e} "
            f"err/tol={ratio:.3f} no-decay control err/tol="
            f"{control_ratio:.3f} (tol {SSD_TOLERANCE}) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=none bound_ms={bound_ms:.4f} ({bound_by})", card)
        del x, dt, cum, b_in, c_in, args, got, want, control
        torch.cuda.empty_cache()
    return results


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def phase_checksum_kernel(params, card: str) -> dict:
    """Every parameter leaf of mamba2-780m as bytes: the kernel's block
    digests and total equal the plain version's exactly.  Control: one
    byte flipped in the embedding changes the total and the digest of
    exactly one block, at offset // 1024."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chunk_checksum import KERNEL

    leaves = [t.reshape(-1).view(torch.uint8) for t in _leaves(params)]
    for i, data in enumerate(leaves):
        total, digests = KERNEL(data, 1024)
        want_total, want_digests = ref.poly_digest_ref(data, 1024)
        if not (torch.equal(digests.view(torch.int32),
                            want_digests.view(torch.int32)) and
                int(total) == int(want_total)):
            raise AssertionError(f"chunk_checksum: leaf {i} "
                                 f"({data.numel()} bytes) differs from the "
                                 f"plain version")
    largest = max(leaves, key=lambda t: t.numel())
    offset = largest.numel() // 3 + 5
    flipped = largest.clone()
    flipped[offset] ^= 0x01
    total, digests = KERNEL(largest, 1024)
    f_total, f_digests = KERNEL(flipped, 1024)
    differ = (f_digests.view(torch.int32) != digests.view(torch.int32)) \
        .nonzero().flatten().tolist()
    if int(f_total) == int(total) or differ != [offset // 1024]:
        raise AssertionError(f"chunk_checksum: flipped byte {offset} gave "
                             f"total {int(f_total)} vs {int(total)}, blocks "
                             f"{differ[:8]}")
    del flipped
    nbytes = sum(t.numel() for t in leaves)
    kernel_ms = time_ms(lambda: [KERNEL(t, 1024) for t in leaves], 5)
    plain_ms = time_ms(lambda: [ref.poly_digest_ref(t, 1024)
                                for t in leaves], 2)
    largest_ms = time_ms(lambda: KERNEL(largest, 1024), 50)
    bound_ms, bound_by = _bound(0, 1.0, nbytes)
    say(f"kernel chunk_checksum: {len(leaves)} leaves, {nbytes} bytes "
        f"(bf16 and f32 leaves as uint8, block 1024): digests and totals "
        f"equal the plain version exactly; flipped byte {offset} of the "
        f"largest leaf ({largest.numel()} bytes) changed the total and only "
        f"block {offset // 1024}; kernel_ms={kernel_ms:.4f} (all leaves, "
        f"{len(leaves)} launches) largest_leaf_ms={largest_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=none bound_ms={bound_ms:.4f} "
        f"({bound_by})", card)
    return dict(max_abs_err=0, err_over_tol=0.0, ms=kernel_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, nbytes=nbytes, leaves=len(leaves))


# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _check_small_model(cfg, label: str, card: str) -> None:
    """The smoke-sized model through the kernels on the card against the
    same weights through the plain path on the CPU: logits and every
    cache leaf within 1e-4, equal greedy outputs and EngineStats."""
    import numpy as np
    import torch

    from repro_torch.models import forward_with_cache, init_lm
    from repro_torch.serve import Request, ServeEngine

    params = init_lm(cfg, seed=0, device="cuda")
    cpu_params = _tree_map(lambda t: t.cpu(), params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    gpu_logits, gpu_cache, _ = forward_with_cache(
        params, torch.as_tensor(tokens, device="cuda"), cfg, max_seq=64)
    cpu_logits, cpu_cache, _ = forward_with_cache(
        cpu_params, torch.as_tensor(tokens), cfg, max_seq=64)
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    cache_err = max((g[n].cpu().float() - c[n].float()).abs().max().item()
                    for g, c in zip(gpu_cache, cpu_cache) for n in g)
    if not (err <= 1e-4 and cache_err <= 1e-4):
        raise AssertionError(f"small model {label}: card vs CPU logits "
                             f"{err}, cache {cache_err} (tol 1e-4)")
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
        f"equal", card)


class _Probe:
    """Times an engine's prefill waves, records their (B, S), times each
    call of one kernel op inside them with CUDA events and records its
    shape, and checks every logit it samples from is finite."""

    def __init__(self, engine, op: str, shape_key) -> None:
        from repro_torch.kernels import ops
        self.prefill_s = 0.0
        self.wave_shapes = []
        self.op_events = []
        self.op_shapes = set()
        self._ops, self._op = ops, op
        self._dispatch = getattr(ops, op)
        prefill, sample = engine._prefill_batch, engine._sample

        def timed_prefill(prompts):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = prefill(prompts)
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

    def __enter__(self):
        setattr(self._ops, self._op, self._timed_op)
        return self

    def __exit__(self, *exc):
        setattr(self._ops, self._op, self._dispatch)

    def op_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.op_events)


def _flash_key(q, k, v, *, causal=True, window=0, softcap=0.0):
    b, s = q.shape[:2]
    return case_name(b, s, window if window < s else 0,
                     str(q.dtype).removeprefix("torch."))


def _ssd_key(x, dt, cum, b_in, c_in):
    b, nc, q, h, p = x.shape
    return ssd_name(b, nc, q, h, p, b_in.shape[-1])


def _drive(name: str, engine, requests, op: str, checked: dict,
           card: str) -> None:
    """Serve ``requests`` through ``engine``; ``op`` is the kernel op of
    the path, launched once per layer per prefill wave, at shapes that
    must all be among ``checked``."""
    import torch
    kernel = _kernels()[op]
    cfg = engine.cfg
    shape_key = _flash_key if op == "flash_attention" else _ssd_key
    torch.cuda.synchronize()
    before = kernel.launches
    t0 = time.perf_counter()
    with _Probe(engine, op, shape_key) as probe:
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
    say(f"engine {name}: prefills={st.prefills} waves={waves} "
        f"wave_shapes={probe.wave_shapes} "
        f"{op}_shapes={sorted(probe.op_shapes)} "
        f"decode_steps={st.decode_steps} tokens_out={st.tokens_out} "
        f"{op}_launches={launches} "
        f"ms_per_prefill_wave={1e3 * probe.prefill_s / waves:.2f} "
        f"{op}_ms_per_wave={op_ms / waves:.2f} (CUDA events, "
        f"{100 * op_ms / (1e3 * probe.prefill_s):.1f}% of prefill) "
        f"ms_per_decode_step="
        f"{1e3 * decode_s / max(st.decode_steps, 1):.2f} "
        f"tokens_per_s={tokens / wall:.2f} wall_s={wall:.2f}", card)


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
    launches = _kernels()["flash_attention"].launches   # ... and ends here
    say(f"serve gemma2-2b: flash launches {launches}, "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    if not launches:
        raise AssertionError("the gemma2 path launched no flash kernel")
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
    checksum = phase_checksum_kernel(params, card)

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
    if len(sums) != checksum["leaves"]:
        raise AssertionError(f"param_checksums: {len(sums)} leaves of "
                             f"{checksum['leaves']}")
    say(f"serve mamba2-780m: param_checksums over {len(sums)} leaves in "
        f"{sums_ms:.2f} ms (host clock; e.g. embed.embedding "
        f"{int(sums['embed.embedding']):#010x})", card)
    _drive("C (batch 4, max_seq 1088, 8 prompts of 64-1000)", engine_c,
           reqs_c, "ssd_intra", checked, card)
    _drive(f"D (batch 1, max_seq 8192, one prompt of {ENGINE_D_PROMPT})",
           engine_d, reqs_d, "ssd_intra", checked, card)
    kernels = _kernels()                     # ... and ends here
    ssd, sums_launches = kernels["ssd_intra"].launches, \
        kernels["chunk_checksum"].launches
    say(f"serve mamba2-780m: ssd_intra launches {ssd}, chunk_checksum "
        f"launches {sums_launches}, max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    if not (ssd and sums_launches == len(sums)):
        raise AssertionError(f"the mamba2 path launched ssd_intra {ssd} and "
                             f"chunk_checksum {sums_launches} times")
    return ssd, sums_launches, checksum


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
            "library_ms": case["library_ms"], "shape": shape, "card": card}


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
    flash_launches = phase_serve_gemma(card, flash)
    torch.cuda.empty_cache()
    ssd_launches, sums_launches, checksum = phase_serve_mamba(card, ssd)
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s", card)
    print(json.dumps({"kernels": [
        _entry("flash_attention", flash_launches, flash[MAIN_CASE],
               TOLERANCE["bfloat16"], MAIN_CASE, card),
        _entry("ssd_intra", ssd_launches, ssd[SSD_MAIN_CASE], SSD_TOLERANCE,
               f"{SSD_MAIN_CASE} float32", card),
        _entry("chunk_checksum", sums_launches, checksum, "exact",
               f"{checksum['leaves']} leaves of mamba2-780m, "
               f"{checksum['nbytes']} bytes as uint8, block 1024", card),
    ]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
