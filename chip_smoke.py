#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX.  Every phase raises on a mismatch, so the exit code is non-zero if
any phase fails:

1. build   — compile the flash attention kernel from ``src/repro_torch``
             and print what ``nvcc -Xptxas -v`` reports for it;
2. kernel  — the kernel against its plain PyTorch version at gemma2-2b's
             attention widths and at every (B, S) the serve phase gives it,
             with a softcap-off control that must fail the same check, and
             kernel, plain, library and bound times;
3. serve   — a small model on the card against the same model on the CPU,
             then gemma2-2b at full width (random weights from seed 0) in
             two engines: a batch of short prompts, and one 4352-token
             prompt that runs the sliding window and wraps the ring cache;
4. report  — one JSON line of kernel numbers, then the device line.

Every line with a measured number names the card and its power limit.
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
ENGINE_A_BATCH = 4
MAIN_CASE = "B1 S4352 window4096 bfloat16"   # engine B's windowed layers
REPLACES = "src/repro/kernels/flash_attention.py:27"


def engine_a_lengths(rng):
    """Engine A's 8 prompt lengths, the first draw from its generator."""
    return rng.integers(64, 257, size=8)


def kernel_cases():
    """(B, S, window, dtype): every shape the serve phase gives the kernel
    in bf16 (engine A's two waves, engine B's windowed and global layers),
    then edge cases."""
    import numpy as np
    lengths = engine_a_lengths(np.random.default_rng(0))
    waves = [int(lengths[i:i + ENGINE_A_BATCH].max())
             for i in range(0, len(lengths), ENGINE_A_BATCH)]
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


def case_name(b: int, s: int, window: int, dtype: str) -> str:
    band = f"window{window}" if window else "causal"
    return f"B{b} S{s} {band} {dtype}"


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


# ---------------------------------------------------------------------------
def phase_build(card: str) -> None:
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    fa.build()
    say(f"build: {fa.LIBRARY.name} in {time.perf_counter() - t0:.1f} s",
        card)
    for line in fa.PTXAS_REPORT.read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            say(f"ptxas: {line.split(':', 1)[-1].strip()}", card)
    say("dynamic shared memory per block: " + ", ".join(
        f"hd {hd}: {fa.KERNEL.smem_bytes(hd)} B" for hd in fa.HEAD_DIMS),
        card)


def _bound(b: int, s: int, window: int, dtype: str, nbytes: int):
    """Least time for the work this input needs: the larger of its
    matrix-product FLOPs (valid (row, column) pairs only) over the type's
    peak and its bytes (q, k, v read once, o written once) over HBM."""
    rows = range(s)
    pairs = sum(r - (max(0, r - window + 1) if window else 0) + 1
                for r in rows)
    flops = 4 * b * H * HD * pairs
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel(card: str) -> dict:
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
        bound_ms, bound_by = _bound(b, s, window, dtype_name, nbytes)
        results[name] = dict(b=b, s=s, window=window, dtype=dtype_name,
                             max_abs_err=err, err_over_tol=ratio,
                             control_err_over_tol=control_ratio,
                             ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        say(f"kernel {name}: max_abs_err={err:.3e} err/tol={ratio:.3f} "
            f"softcap-off control err/tol={control_ratio:.3f} (tol {tol}) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (sdpa causal, softcap 0) "
            f"bound_ms={bound_ms:.4f} ({bound_by})", card)
        del q, k, v, got, control, want, qt, kt, vt
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _check_small_model(card: str) -> None:
    """The smoke-sized model through the kernel on the card against the
    same weights through the plain path on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import forward_with_cache, init_lm
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                              dtype="float32", padded_heads=8)
    params = init_lm(cfg, seed=0, device="cuda")
    cpu_params = _tree_map(lambda t: t.cpu(), params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    gpu_logits, gpu_cache, _ = forward_with_cache(
        params, torch.as_tensor(tokens, device="cuda"), cfg, max_seq=64)
    cpu_logits, cpu_cache, _ = forward_with_cache(
        cpu_params, torch.as_tensor(tokens), cfg, max_seq=64)
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    cache_err = max((g[n].cpu() - c[n]).abs().max().item()
                    for g, c in zip(gpu_cache, cpu_cache) for n in "kv")
    if not (err <= 1e-4 and cache_err <= 1e-4):
        raise AssertionError(f"small model: card vs CPU logits {err}, "
                             f"cache {cache_err} (tol 1e-4)")
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
        raise AssertionError(f"small model: greedy outputs differ, card "
                             f"{outs[0]} vs CPU {outs[1]}")
    say(f"small model (gemma2-2b smoke, f32, 8 padded heads): card vs CPU "
        f"max_abs_err logits={err:.3e} cache={cache_err:.3e} (tol 1e-4); "
        f"greedy outputs and stats equal", card)


class _Probe:
    """Times an engine's prefill waves, records their (B, S), times each
    attention call inside them with CUDA events, and checks every logit it
    samples from is finite."""

    def __init__(self, engine) -> None:
        self.prefill_s = 0.0
        self.wave_shapes = []
        self.attention_events = []
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

        engine._prefill_batch = timed_prefill
        engine._sample = checked_sample

    def timed_attention(self, dispatch):
        """``dispatch`` with CUDA events recorded on the stream around
        each call."""
        import torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = dispatch(*args, **kw)
            end.record()
            self.attention_events.append((start, end))
            return out
        return timed

    def attention_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.attention_events)


def _drive(name: str, engine, requests, checked: dict, card: str) -> None:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import KERNEL
    cfg = engine.cfg
    probe = _Probe(engine)
    dispatch = ops.flash_attention
    ops.flash_attention = probe.timed_attention(dispatch)
    torch.cuda.synchronize()
    before = KERNEL.launches
    t0 = time.perf_counter()
    try:
        engine.generate(requests)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = dispatch
    wall = time.perf_counter() - t0
    launches = KERNEL.launches - before
    st = engine.stats
    waves = len(probe.wave_shapes)
    if launches != cfg.num_layers * waves:
        raise AssertionError(f"engine {name}: {launches} flash launches for "
                             f"{waves} prefill waves of "
                             f"{cfg.num_layers} layers")
    for b, s in probe.wave_shapes:      # every shape was held to the plain
        for window in {0, cfg.sliding_window if cfg.sliding_window < s
                       else 0}:
            if case_name(b, s, window, cfg.dtype) not in checked:
                raise AssertionError(
                    f"engine {name}: wave shape B{b} S{s} window{window} "
                    f"was not checked against the plain version")
    for r in requests:
        if not (r.done and 1 <= len(r.output) <= r.max_new_tokens and
                all(0 <= t < cfg.vocab_size for t in r.output)):
            raise AssertionError(f"engine {name}: bad request {r.rid}: "
                                 f"{r.output}")
    tokens = sum(len(r.output) for r in requests)
    decode_s = wall - probe.prefill_s
    attention_ms = probe.attention_ms()
    say(f"engine {name}: prefills={st.prefills} waves={waves} "
        f"wave_shapes={probe.wave_shapes} "
        f"decode_steps={st.decode_steps} tokens_out={st.tokens_out} "
        f"flash_launches={launches} "
        f"ms_per_prefill_wave={1e3 * probe.prefill_s / waves:.2f} "
        f"flash_ms_per_wave={attention_ms / waves:.2f} (CUDA events, "
        f"{100 * attention_ms / (1e3 * probe.prefill_s):.1f}% of prefill) "
        f"ms_per_decode_step="
        f"{1e3 * decode_s / max(st.decode_steps, 1):.2f} "
        f"tokens_per_s={tokens / wall:.2f} wall_s={wall:.2f}", card)


def phase_serve(card: str, checked: dict) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeEngine

    _check_small_model(card)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    sizes = []
    _tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    say(f"gemma2-2b: {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.resolved_num_heads} q-heads / {cfg.num_kv_heads} KV "
        f"hd={cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"params={n_params} ({cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) "
        f"init_s={time.perf_counter() - t0:.1f}", card)

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

    KERNEL.launches = 0                      # the main path starts here
    _drive("A (batch 4, max_seq 512, 8 prompts of 64-256)", engine_a,
           reqs_a, checked, card)
    _drive("B (batch 1, max_seq 4608, one prompt of 4352)", engine_b,
           reqs_b, checked, card)
    launches = KERNEL.launches               # ... and ends here
    say(f"serve: flash launches {launches}, max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    return launches


# ---------------------------------------------------------------------------
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
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase_build(card)
    kernel = phase_kernel(card)
    launches = phase_serve(card, kernel)
    main_case = kernel[MAIN_CASE]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "err_over_tol": main_case["err_over_tol"],
        "tolerance": TOLERANCE["bfloat16"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": MAIN_CASE, "card": card}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
