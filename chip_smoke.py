#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving paths, training, federation,
sweeps and capacity planner on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX.  Every phase raises on a mismatch, so the exit code is non-zero if
any phase fails:

1. build   — compile the seven kernel libraries from ``src/repro_torch``
             (one ``nvcc`` each, all started together); print what
             ``nvcc -Xptxas -v`` reports for them (registers, spills and
             warnings of both flash designs at every head_dim (the
             ``wgmma`` template at 256, 128, 96 and 64), the three
             ssd_intra designs, ``wgmma`` (P 64), ``wgmma_p128`` (P 128)
             and ``simt``, and its backward's three launches at each
             (P, N)), each design's
             shared memory (the waterfill's at H's and I's buckets, the
             FIFO replay's two designs, the planner's solve at 2, 28 and
             252 caches), and the count of HGMMA
             instructions in the
             flash and ssd_scan libraries' SASS, neither of which may be 0;
2. kernel  — each kernel against its plain PyTorch version:
             flash attention at gemma2-2b's widths (hd 256, softcap 50),
             mixtral-8x22b's and qwen2-7b's (hd 128, no softcap),
             deepseek-coder-33b's and phi3.5-moe's (hd 128),
             phi3-mini-3.8b's (hd 96, MHA) and musicgen-medium's (hd 64,
             MHA) and every (B, S, window) their engines give it, ragged S
             of 100 at hd 96 and 64, jamba-1.5-large's 8,000-token prompt
             and llama-3.2-vision's 2 prompts of 256 (hd 128), with a
             control that must fail the same check (softcap off; without
             a softcap, window 0 or no causal mask), the design that ran
             and its TFLOP/s;
             ssd_intra at mamba2-780m's widths and every (B, NC, Q) the
             mamba2 engines give it, at the smoke widths, and at
             jamba-1.5-large's (H 128, P 128, N 128: its 8,000-token
             prompt's 32 chunks and engine A's two waves, Q 228 and 123),
             with a no-decay control; the design that ran, its TFLOP/s,
             kernel,
             plain, library and bound times (fp32 CUDA cores, and the
             tensor cores' 3xTF32 route);
             fnv1a64_chunks against the host ``fnv1a64`` bit for bit (an
             object of two 24 MiB chunks and a tail of 24 MiB - 1 B, an
             unaligned 7 B object, the empty object, the kernel's segment
             length L - 1, L and L + 1 bytes, chunks of L + 1, 1,000
             segments unaligned, chunks of 70 segments), each call counted
             on its design (short, split), with flipped-byte controls
             (mid-chunk, a segment's first and last byte) that must fail
             ``Payload.verify``; ms a chunk, ns a byte, the host loop's ms
             and the bound (the chunk's bytes read once);
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
             the weight leg, after those weights are freed: mamba2-780m's
             48 layers (random bf16 weights, seed 0) saved by
             ``FederatedCheckpointer`` in the reference's layout through a
             one-pod fleet whose chunk digests run on the card, drained,
             restored by ``ServeEngine.from_federation``: every leaf
             bit-exact, no checksum failure, stored bytes the ``.npy``
             sizes and the manifest, a corrupted cached chunk caught and
             refetched, engine C's tokens equal to the in-memory
             engine's; save, drain, restore and digest times, the
             digests' designs, and one verified 24 MiB read split into
             the host copy, the copy to the card, the kernel and the
             read back;
             qwen2-7b: a small model card-vs-CPU check, then full width
             (28 layers, 15.4 GB of random bf16 weights) in engine A's
             shape, every flash launch on ``wgmma`` at hd 128;
             deepseek-coder-33b at full width and depth (62 layers, 68.5
             GB of bf16 weights, 56 q-heads padded to 64 over 8 KV) in
             engine A's shape; phi3.5-moe, 24 of 32 layers (62.9 GB; the
             only cut) in engine E's shape with the MoE layer's shares;
             phi3-mini-3.8b (hd 96) in engine A's shape and one
             4,000-token prompt; musicgen-medium (hd 64) over frame ids in
             engine A's shape and one 1,500-frame prompt: each after a
             small model card-vs-CPU check (phi3.5-moe's with its
             routing), every weight bf16 (the routers float32), every
             flash launch on ``wgmma`` at the config's widths;
             jamba-1.5-large's hybrid stack, its first 5 of 72 layers
             (``depth_cut``: each block kind once, 47.98 GB; one 8-layer
             group is 90.3 GB) after its smoke model's card-vs-CPU check
             (routing compared, ssd_intra on ``simt``), in engine A's
             shape and one 8,000-token prompt, every ssd_intra launch on
             ``wgmma_p128`` at (128, 128) and every flash launch on
             ``wgmma`` at H64 KV8 hd128, with the MoE shares;
             llama-3.2-vision-90b, 35 of 100 layers (7 whole groups,
             64.10 GB) in engine A's shape, its cross-attention layers
             served as self-attention through flash (the reference's
             engine passes no image); then its real cross-attention on
             the same weights: 2 prompts of 256 with (2, 1600, 8192) bf16
             image states and 8 decode steps, the logits bit-equal to a
             blank image's at gates 0 and different at gates 0.5;
             ``launch.serve`` at its defaults on the card, its two lines;
   train   — flash attention's backward kernel against its plain version
             at each training path's shape, all on the ``wgmma`` design:
             qwen2-7b's (B4 S1024 H32 KV4 hd128 bf16, causal), gemma2-2b's
             (B1 S8192 H16 KV4 hd256, window 4096, softcap 50),
             phi3-mini-3.8b's (B4 S1024 H32 KV32 hd96) and
             musicgen-medium's (B4 S1024 H24 KV24 hd64), and on ``simt``
             at float32 hd 16 with a window and with a softcap, each with
             a control (dO moved by 1e-2 of its scale) that must fail, its
             lse against the plain version's; kernel, plain and library
             (autograd through SDPA; none with the softcap) times and the
             bound (10·hd FLOPs a visible pair); ssd_intra's backward
             kernel (``simt_p64``, ``simt_p128``, ``simt``) against its
             plain version in float64 on the card at every ssd_intra
             shape above and at the training shapes of mamba2-780m (B4
             NC4 Q256 H48 P64 N128) and jamba-1.5-large (H128 P128 N128),
             within 1e-5 of each output's largest magnitude beside the
             float32 plain version's own distance, with two controls
             that must fail (dcum without its −j term, dy moved by 1e-2
             of its scale) and two launches bit-equal; kernel, plain and
             bound times (Q(Q+1)/2·(6N + 4HP) operations a chunk);
             qwen2-7b's and mamba2-780m's smoke models trained 10 steps
             on the card and on the CPU from the same init; then at full
             width, random bf16 weights, float32 moments, ``Trainer.run``
             over a ``FederatedDataLoader`` on ``fleet(2, 8)``: qwen2-7b's
             first 8 of 28 layers (``depth_cut``) for 6 steps of 4 x
             1,024 tokens, gemma2-2b's first 16 of 26 for 2 steps of 1 x
             8,192, phi3-mini-3.8b (all 32), musicgen-medium (all 48),
             mamba2-780m (all 48), jamba-1.5-large's first 1 of 72 (an SSM
             layer at H 128, P 128, N 128 with a dense FFN) and
             mixtral-8x22b's first 1 of 56 (attention and the MoE layer)
             for 2 steps of 4 x 1,024, each after one step through the
             kernels against the same step with the plain versions on
             the card (``attention_ref`` with the attention's projections
             rescaled to their true fan-in, ``ssd_intra_ref``; every MoE
             layer's routing held to the plain step's): the loss, the
             gradient norm, every attention projection's gradient with a
             control (dK of a sequence's first 128 keys dropped) and every
             SSM layer's in_x, in_b, in_c, in_dt and a_log gradients with a
             control (dcum without its −j term), each control required to
             fail; every loss finite, every flash launch ``wgmma``
             (forward and remat) and every flash backward ``wgmma``, every
             ssd_intra launch on the widths' design (forward and remat)
             and every ssd_intra backward on its backward design, ms a
             step and its split (flash, ssd_intra forward and backward,
             ``adamw_update``, the rest), tokens/s, peak memory;
             ``launch.train`` at the reference's defaults and with
             ``--grad-compression int8_ef --fail-at 20``, its line, the
             restart replaying the uninterrupted run;
4. federation — the port's data plane on the simulated engine, its
             max-min solver on the card (the ``maxmin_waterfill`` kernel,
             one launch a solve):
             G: the paper's §4.1 protocol at the five OSG sites (four
             sequential fetches of each evaluation file: proxy cold and
             warm, stash cold and warm) on solver "auto" and, with every
             solve on the card, on "vector", within 1e-4 of "auto" and
             equal byte for byte to its CPU run; download speeds and
             Table 3 beside the paper's;
             H: a restart storm over a 250-pod fleet (1,000 workers pull
             a 2 GB checkpoint within 2 s), every solve on the card, one
             kernel launch each (counted): its counters against the
             reference's, a second run equal byte for byte, the scalar
             solver's run with equal counters and seconds within 1e-4,
             and at three recorded solves (the peak among them) the
             card's rates against the float64 oracle and the plain
             version on the CPU and on the card, each with a control that
             must fail; solves, launches, flows, rounds, host syncs and
             copies per solve, ms per solve against the scalar solver's,
             the share of the wall time spent solving; the kernel alone
             (a CUDA graph of launches), the plain version, and the whole
             call split into host packing, copy, launch and read;
5. sweep   — I: an eviction sweep at a day's traffic (``run_sweep`` over
             a 4-pod fleet, 4,000 zipf requests, capacity x policy x
             admission x outage: 32 cells, all batched), its three scan
             kernels (stack distances, the LRU/FIFO slot machine, the
             FIFO frontier, every launch of it on the ``smem`` design)
             and the batched max-min solver (one waterfill launch a
             bucket) on the card:
             totals equal to the reference's; every problem the sweep
             handed a scan solved again by its plain version on the card,
             exactly equal, with a control one byte below a deciding
             capacity that must fail; the solver's rates against the
             plain version on the CPU; four cells on the serial executor
             with the eviction counters equal; each kernel's buckets,
             launches, ms per launch, µs per dependent step of the
             replays, plain time and bound, the solver's rounds and host
             reads, and the kernels' share of the wall time;
6. planner — J: the capacity planner, its inverse solve (``plan_solve``,
             one launch a plan) and its mixture fit (``mixture_fit``, one
             launch a stream) on the card: J1, the reference CI's planner
             gate (``bench_plan.py``'s heterogeneous scenario at its full
             profile: a fit sweep, a plan at target 0.5 and its exact
             replay; savings above 0.15); J2, the OSDF's two tiers at 4
             regions x 6 edges (28 caches), a day of zipf traffic: the
             fit sweep's counters equal the reference's and the sweep's
             without fit, a plan, a plan under an egress budget halfway
             between the egress at ``max_capacity`` and the first plan's,
             and the first plan's verification; J3, the same sweep fitting
             mixtures.  Plans, verification blocks and losses against the
             reference's numbers (``tests/tools/reference_want.py``); each
             kernel against its plain version on the card, two launches
             to the same bits, with a control that must fail (a plan at
             target + 0.001, a budget plan under a budget moved by 1e-3
             of its span, a fit to a target moved by 1e-3 at one point);
             J2's pricing against the plain version on the CPU, with a
             control (a saturated link halved); the
             kernels' times (CUDA events around 20 calls, a CUDA graph),
             the plain versions' on the card and the CPU, at J2 and at
             J2's models tiled to 252 caches, ``plan_capacity`` whole,
             the mixture per stream and batched, and the fit sweep's wall
             against the sweep's without fit; the waterfill's largest
             buckets (design ``global_flows``) and its buckets of 8,192
             links or more (Lp 16384 and 32768, design ``global_links``)
             equal to the plain version bit for bit, with controls;
7. report  — one JSON line of kernel numbers, then the device line.

Each serving path, the weight leg, each training path, storm H, sweep I
and the planner's path J runs with
every launch count set to 0 just before it and read just after.  Every line with a measured
number names the card and its power limit.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple, Optional

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
QWEN2 = Widths(32, 4, 128, 0.0)        # 32 q-heads, 4 of them zero pads
DEEPSEEK = Widths(64, 8, 128, 0.0)     # 64 q-heads, 8 of them zero pads
PHI35_MOE = Widths(32, 8, 128, 0.0)
PHI3_MINI = Widths(32, 32, 96, 0.0)    # MHA at hd 96: three 32-column slabs
MUSICGEN = Widths(24, 24, 64, 0.0)     # MHA at hd 64
JAMBA = Widths(64, 8, 128, 0.0)        # its attention layer (1 of 8)
LLAMA = Widths(64, 8, 128, 0.0)        # self- and (served) xattn layers
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
PHI35_LAYERS = 24                # of 32: the bf16 weights, 62.9 GB, fit
PHI3_MINI_PROMPT = 4000          # inside phi3-mini's 4K context
MUSICGEN_PROMPT = 1500           # frames: 30 s at 50 Hz
JAMBA_LAYERS = 5                 # of 72: each block kind once, 47.98 GB
LLAMA_LAYERS = 35                # of 100: 7 whole groups, 64.10 GB
IMAGE_TOKENS = 1600              # llama's image states a prompt
XATTN_PROMPT = 256               # the cross-attention check's 2 prompts
XATTN_STEPS = 8
# llama's 5-layer smoke stack in float32 is itself 2.4e-4 from float64 on
# the CPU (deepseek's 2 layers: 2.5e-5; test_torch_hybrid.py measures
# it): its card-vs-CPU logits are held to four times that, not to 1e-4
LLAMA_SMOKE_TOL = 1e-3
SSD_MAIN_CASE = "B1 NC32 Q256 H48 P64 N128"    # engine D's long prompt
SSD_P128_CASE = "B1 NC32 Q256 H128 P128 N128"  # jamba's 8,000 tokens
# kernel: (its source, the TPU kernel it replaces)
KERNEL_FILES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:27"),
    # the gradient of that kernel's function: the reference trains by
    # jax.grad of its plain attention and has no backward kernel
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:27"),
    "ssd_intra": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                  "src/repro/kernels/ssd_scan.py:24"),
    # the gradient of that kernel's function: the reference trains by
    # jax.grad of its plain jnp and has no backward kernel
    "ssd_intra_backward": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:24"),
    "chunk_checksum": ("src/repro_torch/kernels/csrc/chunk_checksum.cu",
                       "src/repro/kernels/chunk_checksum.py:40"),
    "stack_distance": ("src/repro_torch/kernels/csrc/stack_distance.cu",
                       "src/repro/kernels/stack_distance.py:75"),
    "cache_sim": ("src/repro_torch/kernels/csrc/stack_distance.cu",
                  "src/repro/kernels/stack_distance.py:101"),
    "fifo_replay": ("src/repro_torch/kernels/csrc/stack_distance.cu",
                    "src/repro/kernels/stack_distance.py:165"),
    "maxmin": ("src/repro_torch/kernels/csrc/maxmin.cu",
               "src/repro/kernels/maxmin.py:36"),
    "batched_maxmin": ("src/repro_torch/kernels/csrc/maxmin.cu",
                       "src/repro/kernels/batched_maxmin.py:38"),
    "plan_solve": ("src/repro_torch/kernels/csrc/cache_model.cu",
                   "src/repro/core/planner.py:162"),
    "mixture_fit": ("src/repro_torch/kernels/csrc/cache_model.cu",
                    "src/repro/kernels/cache_model.py:267"),
    # no TPU kernel: the reference's host loop over real-bytes chunks
    "fnv1a64_chunks": ("src/repro_torch/kernels/csrc/fnv1a.cu",
                       "src/repro/core/chunk.py:27")}


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
    float32 at both head dims; then the shapes of the deepseek-coder-33b,
    phi3.5-moe, phi3-mini-3.8b (hd 96) and musicgen-medium (hd 64) engines
    (engine A's two waves each, phi3-mini's 4,000-token prompt, musicgen's
    1,500 frames) and a ragged S of 100 at hd 96 and 64; jamba-1.5-large's
    8,000-token prompt and llama-3.2-vision's 2 prompts of 256 with an
    image (their engine A waves are deepseek's widths, H64 KV8 hd128)."""
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
        *[(QWEN2, ENGINE_A_BATCH, s, 0, "bfloat16") for s in waves],
        (MIXTRAL, 1, 1024, 0, "float32"),
        (MIXTRAL, 1, 300, 100, "float32"),
        *[(w, ENGINE_A_BATCH, s, 0, "bfloat16")
          for w in (DEEPSEEK, PHI35_MOE, PHI3_MINI, MUSICGEN) for s in waves],
        (PHI3_MINI, 1, PHI3_MINI_PROMPT, 0, "bfloat16"),
        (PHI3_MINI, 1, 100, 0, "bfloat16"),        # ragged, under 128
        (MUSICGEN, 1, MUSICGEN_PROMPT, 0, "bfloat16"),
        (MUSICGEN, 1, 100, 0, "bfloat16"),
        (JAMBA, 1, ENGINE_D_PROMPT, 0, "bfloat16"),
        (LLAMA, 2, XATTN_PROMPT, 0, "bfloat16"),
    ]


def _chunks(length: int, chunk: int):
    """(NC, Q) of ``ssd_chunked`` for a sequence of ``length``."""
    q = min(chunk, length)
    return -(-length // q), q


def ssd_cases():
    """(B, NC, Q, H, P, N): every shape the mamba2 engines give the
    ssd_intra kernel (engine C's two waves, engine D's prompt), the smoke
    config's widths, then jamba-1.5-large's (H 128, P 128, N 128): its
    8,000-token prompt's 32 chunks and engine A's two waves, chunks
    shorter than the 256 of the model."""
    import numpy as np
    waves = _wave_lengths(engine_c_lengths(np.random.default_rng(0)),
                          ENGINE_C_BATCH)
    waves_a = _wave_lengths(engine_a_lengths(np.random.default_rng(0)),
                            ENGINE_A_BATCH)
    return [*[(ENGINE_C_BATCH, *_chunks(s, 256), 48, 64, 128) for s in waves],
            (1, *_chunks(ENGINE_D_PROMPT, 256), 48, 64, 128),
            (2, 5, 8, 8, 16, 16),
            (1, *_chunks(ENGINE_D_PROMPT, 256), 128, 128, 128),
            *[(ENGINE_A_BATCH, *_chunks(s, 256), 128, 128, 128)
              for s in waves_a]]


def case_name(w: Widths, b: int, s: int, window: int, dtype: str) -> str:
    band = f"window{window}" if window else "causal"
    return f"B{b} S{s} {band} {dtype} H{w.h} KV{w.kv} hd{w.hd}"


# engine B's and engine F's windowed layers
MAIN_CASE = case_name(GEMMA2, 1, 4352, 4096, "bfloat16")
MAIN_CASE_128 = case_name(MIXTRAL, 1, ENGINE_F_PROMPT, 4096, "bfloat16")
# phi3-mini-3.8b's long prompt and musicgen-medium's 1,500 frames
MAIN_CASE_96 = case_name(PHI3_MINI, 1, PHI3_MINI_PROMPT, 0, "bfloat16")
MAIN_CASE_64 = case_name(MUSICGEN, 1, MUSICGEN_PROMPT, 0, "bfloat16")


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


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """The device time of one call of ``fn`` (a kernel's launch alone):
    ``launches`` calls captured in a CUDA graph, replayed ``replays``
    times between CUDA events, so the host's work around each launch
    (the wrapper's checks and allocation) stays out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _kernels():
    from repro_torch.kernels import cache_model, chunk_checksum, fnv1a
    from repro_torch.kernels import flash_attention, maxmin, ssd_scan
    from repro_torch.kernels import stack_distance as sd
    return {"flash_attention": flash_attention.KERNEL,
            "flash_attention_backward": flash_attention.BACKWARD,
            "fnv1a64_chunks": fnv1a.KERNEL,
            "ssd_intra": ssd_scan.KERNEL,
            "ssd_intra_backward": ssd_scan.BACKWARD,
            "chunk_checksum": chunk_checksum.KERNEL,
            "stack_distance": sd.DISTANCES, "cache_sim": sd.CACHE_SIM,
            "fifo_replay": sd.FIFO_REPLAY, "maxmin": maxmin.WATERFILL,
            "plan_solve": cache_model.PLAN_SOLVE,
            "mixture_fit": cache_model.MIXTURE_FIT}


def _reset_counts() -> None:
    for kernel in _kernels().values():
        kernel.launches = 0
        if hasattr(kernel, "launches_by_design"):
            kernel.launches_by_design = dict.fromkeys(
                kernel.launches_by_design, 0)


# ---------------------------------------------------------------------------
def phase_build(card: str) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import cache_model as cm
    from repro_torch.kernels import chunk_checksum as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fnv1a, maxmin, ssd_scan
    from repro_torch.kernels import stack_distance as sd
    libs = (fa.LIB, ssd_scan.LIB, cc.LIB, sd.LIB, maxmin.LIB, cm.LIB,
            fnv1a.LIB)
    t0 = time.perf_counter()
    _build.build(*libs)
    say(f"build: {', '.join(lib.path.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)", card)
    entries = {"flash_bwd_wgmma": "backward wgmma design: ",
               "flash_bwd": "backward simt design: ",
               "flash_wgmma": "wgmma design: ",
               "flash_attention_kernel": "simt design: ",
               "ssd_wgmma_kernelILi128E": "wgmma_p128 design: ",
               "ssd_wgmma_kernelILi64E": "wgmma design: ",
               "ssd_simt_kernel": "simt design: ",
               "ssd_bwd_scores": "backward scores launch: ",
               "ssd_bwd_heads": "backward heads launch: ",
               "ssd_bwd_reduce": "backward reduce launch: "}
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
        + ", " + ", ".join(
            f"flash backward {fa.BACKWARD.design(dtype, hd)} "
            f"({str(dtype)[6:]}, hd {hd}): dK/dV and dQ blocks "
            f"{fa.BACKWARD.smem_bytes(dtype, hd)} B"
            for dtype, hd in fa.BACKWARD_DESIGNS)
        + ", " + ", ".join(f"ssd_intra {ssd_scan.KERNEL.design(p, n)} "
                           f"(P {p}, N {n}, Q 256): "
                           f"{ssd_scan.KERNEL.smem_bytes(p, n, 256)} B"
                           for p, n in ssd_scan.DESIGNS)
        + ", " + ", ".join(
            f"maxmin_waterfill {maxmin.WATERFILL.design(f, lp, w)} (Fp {f}, "
            f"Lp {lp}, width {w}): {maxmin.WATERFILL.smem_bytes(f, lp, w)} "
            f"B, {maxmin.WATERFILL.threads(f)} threads"
            for f, lp, w in ((512, 512, 8), (8192, 32, 8), (16384, 256, 8),
                             (32768, 256, 8), (131072, 256, 8),
                             (64, 16384, 4), (1024, 32768, 8)))
        + ", " + ", ".join(
            f"{name} {kernel.design(kp)} (Kp {kp}): "
            f"{kernel.smem_bytes(kp)} B" for name, kernel in (
                ("fifo_replay", sd.FIFO_REPLAY), ("cache_sim", sd.CACHE_SIM))
            for kp in (16384, 32768)) + ", " + ", ".join(
            f"plan_solve (N {n}, Bk 64, "
            f"G {n}): {cm.PLAN_SOLVE.smem_bytes(n, n)} B, a cluster of "
            f"{cm.PLAN_SOLVE.cluster(n, n)} CTAs of "
            f"{cm.PLAN_SOLVE.threads(n, n)} threads"
            for n in (2, 28, 252, 2048)),
        card)
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


def _leaf_items(tree, path=""):
    """(dotted name, tensor) of every leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{path}.{i}")
    else:
        yield path, tree


def _leaves(tree):
    return [leaf for _, leaf in _leaf_items(tree)]


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


def _check_small_model(cfg, label: str, card: str,
                       logits_tol: float = 1e-4) -> None:
    """The smoke-sized model through the kernels on the card against the
    same weights through the plain path on the CPU: logits within
    ``logits_tol`` and every cache leaf within 1e-4 (of its largest
    magnitude), equal greedy outputs and EngineStats.  For an
    MoE model the first 30 of row 0's 40 tokens are token 0, as the engine
    left-pads a wave: the pads route alike and overflow an expert's C =
    25 slots in every MoE layer (in a stack with SSM mixers, whose state
    moves the pads apart, in some MoE layer).  Every MoE layer's routing
    (expert, slot, kept) must be equal on the card and the CPU, and pairs
    must have dropped."""
    import numpy as np
    import torch

    from repro_torch.models import forward_with_cache, init_lm
    from repro_torch.models.model import layer_specs
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
    # each cache leaf within 1e-4 of its largest magnitude (at least 1):
    # an SSM state of a deep smoke stack reaches ~27 (jamba's), where
    # float32's summation orders differ by ~1e-5 of it
    cache_err = max((g[n].cpu().float() - c[n].float()).abs().max().item()
                    / max(1.0, c[n].float().abs().max().item())
                    for g, c in zip(gpu_cache, cpu_cache) for n in g)
    if not (err <= logits_tol and cache_err <= 1e-4):
        raise AssertionError(f"small model {label}: card vs CPU logits "
                             f"{err} (tol {logits_tol:g}), cache "
                             f"{cache_err} (tol 1e-4 of its leaf's "
                             f"largest magnitude)")
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
        specs = layer_specs(cfg)
        overflow = any if any(s.mixer == "ssm" for s in specs) else all
        if len(dropped) != sum(s.ffn == "moe" for s in specs) or \
                not overflow(dropped):
            raise AssertionError(f"small model {label}: dropped pairs per "
                                 f"MoE layer {dropped}; the pads must "
                                 f"overflow")
        routing = (f"; routing (expert, slot, kept) equal in all "
                   f"{len(dropped)} MoE layers, capacity "
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
        f"(tol {logits_tol:g}) "
        f"cache={cache_err:.3e} (tol 1e-4; the cache's over its leaf's "
        f"largest magnitude, at least 1); greedy outputs and stats "
        f"equal{routing}", card)


class _Probe:
    """Times an engine's prefill waves, records their (B, S), times each
    call of the kernel ops ``shape_keys`` names inside them with CUDA
    events and records its shape, and checks every logit it samples from
    is finite.  ``timed`` names more functions, as ``(module, name,
    flops)``, whose calls it times with CUDA events apart in prefill and
    in decode, with their matrix-product FLOPs when ``flops`` is given."""

    def __init__(self, engine, shape_keys: dict, timed=()) -> None:
        from repro_torch.kernels import ops
        self.prefill_s = 0.0
        self.wave_shapes = []
        self.op_events = {op: [] for op in shape_keys}
        self.op_shapes = {op: set() for op in shape_keys}
        self._ops = ops
        self._dispatch = {op: getattr(ops, op) for op in shape_keys}
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

        def timed_op(op, shape_key):
            def call(*args, **kw):
                import torch
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = self._dispatch[op](*args, **kw)
                end.record()
                self.op_events[op].append((start, end))
                self.op_shapes[op].add(shape_key(*args, **kw))
                return out
            return call

        engine._prefill_batch = timed_prefill
        engine._sample = checked_sample
        self._timed_ops = {op: timed_op(op, key)
                           for op, key in shape_keys.items()}

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
        for op, timed in self._timed_ops.items():
            setattr(self._ops, op, timed)
        for op_module, name, _, timed in self._patches:
            setattr(op_module, name, timed)
        return self

    def __exit__(self, *exc):
        for op, fn in self._dispatch.items():
            setattr(self._ops, op, fn)
        for op_module, name, fn, _ in self._patches:
            setattr(op_module, name, fn)

    def op_ms(self, op: str) -> float:
        return sum(s.elapsed_time(e) for s, e in self.op_events[op])

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


# the mixers that launch each kernel op of a prefill wave once a layer
# (cross-attention with no image runs as self-attention, through flash)
OP_MIXERS = {"flash_attention": ("attn", "attn_local", "xattn"),
             "ssd_intra": ("ssm",)}
SHAPE_KEYS = {"flash_attention": _flash_key, "ssd_intra": _ssd_key}


def _drive(name: str, engine, requests, op: str, checked: dict,
           card: str, timed=(), also=None) -> dict:
    """Serve ``requests`` through ``engine``; ``op`` is the kernel op of
    the path, launched once per layer of its mixers per prefill wave, at
    shapes that must all be among ``checked``; ``also`` maps further ops
    of the path to their checked shapes, held alike; ``timed`` as
    ``_Probe`` takes it.  Returns the run's numbers, and the ops'
    shapes."""
    import torch

    from repro_torch.models.model import layer_specs
    cfg = engine.cfg
    checked_by_op = {op: checked, **(also or {})}
    kernels = {o: _kernels()[o] for o in checked_by_op}
    torch.cuda.synchronize()
    before = {o: k.launches for o, k in kernels.items()}
    t0 = time.perf_counter()
    with _Probe(engine, {o: SHAPE_KEYS[o] for o in checked_by_op},
                timed) as probe:
        engine.generate(requests)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats
    waves = len(probe.wave_shapes)
    launches = {}
    for o, kernel in kernels.items():
        launches[o] = kernel.launches - before[o]
        layers = sum(s.mixer in OP_MIXERS[o] for s in layer_specs(cfg))
        if launches[o] != layers * waves:
            raise AssertionError(f"engine {name}: {launches[o]} {o} "
                                 f"launches for {waves} prefill waves of "
                                 f"{layers} layers that launch it")
        unchecked = probe.op_shapes[o] - set(checked_by_op[o])
        if unchecked:
            raise AssertionError(f"engine {name}: {o} shapes {unchecked} "
                                 f"were not checked against the plain "
                                 f"version")
    for r in requests:
        if not (r.done and 1 <= len(r.output) <= r.max_new_tokens and
                all(0 <= t < cfg.vocab_size for t in r.output)):
            raise AssertionError(f"engine {name}: bad request {r.rid}: "
                                 f"{r.output}")
    tokens = sum(len(r.output) for r in requests)
    decode_s = wall - probe.prefill_s
    ops_line = ""
    for o in checked_by_op:
        op_ms = probe.op_ms(o)
        ops_line += (f"{o}_shapes={sorted(probe.op_shapes[o])} "
                     f"{o}_launches={launches[o]} "
                     f"{o}_ms_per_wave={op_ms / waves:.2f} (CUDA events, "
                     f"{100 * op_ms / (1e3 * probe.prefill_s):.1f}% of "
                     f"prefill) ")
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
        f"decode_steps={st.decode_steps} tokens_out={st.tokens_out} "
        f"{ops_line}"
        f"ms_per_prefill_wave={1e3 * probe.prefill_s / waves:.2f} "
        f"{shares}ms_per_decode_step="
        f"{1e3 * decode_s / max(st.decode_steps, 1):.2f} "
        f"tokens_per_s={tokens / wall:.2f} wall_s={wall:.2f} "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    return {"shapes": sorted(probe.op_shapes[op]),
            "shapes_by_op": {o: sorted(v) for o, v in
                             probe.op_shapes.items()},
            "ms_per_prefill_wave": 1e3 * probe.prefill_s / waves,
            "ms_per_decode_step": 1e3 * decode_s / max(st.decode_steps, 1),
            "tokens_per_s": tokens / wall,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


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
# The chunks' digests and the weight leg through the federation
# ---------------------------------------------------------------------------
MiB = 2 ** 20


def _fnv_buffer(data: bytes, offset: int = 0):
    """``data`` on the card at ``offset`` bytes past an aligned start."""
    import numpy as np
    import torch
    padded = np.zeros(offset + len(data), np.uint8)
    padded[offset:] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(padded).to("cuda")[offset:]


def phase_fnv_kernel(card: str) -> dict:
    """``fnv1a64_chunks`` against the host ``fnv1a64`` bit for bit: an
    object of two whole 24 MiB chunks and a tail of 24 MiB - 1 B, an
    unaligned 7 B object, the empty object, objects of the kernel's own
    segment length L - 1, L and L + 1 bytes, an object of 3 chunks of
    L + 1, an unaligned object of 1,000 segments and 7 B, and one of 2
    chunks of 70 segments + 3 and a last of L + 2.  Controls: a byte
    flipped in the middle chunk, at a segment's first byte and at a
    segment's last byte, must each change that chunk's digest alone, and
    a payload of that chunk holding its kept digest must fail
    ``Payload.verify`` on the card.  Times: a 24 MiB chunk's call (CUDA
    events), the three-chunk object's, the host loop over a chunk (host
    clock); the bound is the chunk's bytes read once at 3.35 TB/s."""
    import numpy as np

    from repro_torch.core.chunk import DEFAULT_CHUNK_SIZE as C
    from repro_torch.core.chunk import Payload, fnv1a64
    from repro_torch.kernels import fnv1a, ops
    L = fnv1a.SEG
    rng = np.random.default_rng(0)

    def data(n):
        return rng.integers(0, 256, n, np.uint8).tobytes()
    big = data(3 * C - 1)
    cases = {"3 chunks, the last 24 MiB - 1 B": (big, 0, C),
             "7 B at offset 5": (data(7), 5, C),
             "empty": (b"", 0, C),
             "L - 1 B": (data(L - 1), 0, C), "L B": (data(L), 0, C),
             "L + 1 B": (data(L + 1), 0, C),
             "3 chunks of L + 1": (data(3 * (L + 1)), 0, L + 1),
             "1,000 segments + 7 B at offset 3": (data(1000 * L + 7), 3, C),
             "2 chunks of 70 segments + 3, a last of L + 2, at offset 9": (
                 data(2 * (70 * L + 3) + L + 2), 9, 70 * L + 3)}
    before = dict(fnv1a.KERNEL.launches_by_design)
    host_s, digests = [], {}
    for label, (raw, offset, chunk) in cases.items():
        want = []
        for off in range(0, max(len(raw), 1), chunk):
            t0 = time.perf_counter()
            want.append(fnv1a64(raw[off:off + chunk]))
            if chunk == C:
                host_s.append((time.perf_counter() - t0,
                               len(raw[off:off + chunk])))
        got = fnv1a.unsigned(ops.fnv1a64_chunks(_fnv_buffer(raw, offset),
                                                chunk))
        if got != want:
            raise AssertionError(f"fnv1a64_chunks ({label}): {got} differs "
                                 f"from the host loop's {want}")
        digests[label] = got
    designs = {k: v - before[k]
               for k, v in fnv1a.KERNEL.launches_by_design.items()}
    if digests["empty"] != [0xCBF29CE484222325]:
        raise AssertionError("fnv1a64_chunks: the empty object's digest is "
                             "not the offset basis")
    if designs != {"short": 4, "split": 5}:
        raise AssertionError(f"fnv1a64_chunks: designs {designs}, not 4 "
                             f"short and 5 split")
    buf = _fnv_buffer(big)
    want = digests["3 chunks, the last 24 MiB - 1 B"]
    flips = {"mid-chunk": C + C // 2, "a segment's first byte": C + 5 * L,
             "a segment's last byte": C + 6 * L - 1}
    for where, flip in flips.items():
        bad = buf.clone()
        bad[flip] ^= 0x01
        flipped = fnv1a.unsigned(ops.fnv1a64_chunks(bad, C))
        changed = [i for i, (a, b) in enumerate(zip(flipped, want))
                   if a != b]
        kept = Payload(size=C, data=bad[C:2 * C].cpu().numpy().tobytes(),
                       digest=want[1])
        if changed != [1] or kept.verify("cuda"):
            raise AssertionError(f"fnv1a64_chunks control ({where}): "
                                 f"flipped byte {flip} changed chunks "
                                 f"{changed}; verify of the kept digest "
                                 f"passed")
    ms = time_ms(lambda: fnv1a.KERNEL(buf[:C], C), 20)
    object_ms = time_ms(lambda: fnv1a.KERNEL(buf, C), 20)
    whole = [sec for sec, n in host_s if n == C]
    plain_ms = 1e3 * sum(whole) / len(whole)
    bound_ms = 1e3 * C / HBM_BYTES_PER_S
    say(f"kernel fnv1a64_chunks: {len(cases)} objects equal the host loop "
        f"bit for bit (3 chunks, the last 24 MiB - 1 B; 7 B at offset 5; "
        f"empty; L - 1, L, L + 1 B at L = {L}; 3 chunks of L + 1; 1,000 "
        f"segments + 7 B at offset 3; 2 chunks of 70 segments + 3 and L + 2 "
        f"at offset 9), designs {designs}; controls: a byte flipped "
        f"{', '.join(f'{k} ({v})' for k, v in flips.items())} changed "
        f"chunk 1 alone and failed verify on the card; {ms:.4f} ms a 24 "
        f"MiB chunk (CUDA events around 20 calls, {1e6 * ms / C:.5f} ns a "
        f"byte, {bound_ms / ms:.4f} of the bytes bound {bound_ms:.5f} ms), "
        f"the 3-chunk object {object_ms:.4f} ms in one call; host loop "
        f"{plain_ms:.1f} ms a chunk (host clock)", card)
    return dict(max_abs_err=0, err_over_tol=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by="bytes",
                object_ms=object_ms, ns_per_byte=1e6 * ms / C,
                designs=designs)


class _DigestTimes:
    """CUDA events around every ``ops.fnv1a64_chunks`` call while the
    context is open (``core.chunk`` calls it through the module)."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops
        self.events, self._ops, self._fn = [], ops, ops.fnv1a64_chunks

        def timed(buf, chunk_size):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._fn(buf, chunk_size)
            end.record()
            self.events.append((start, end))
            return out
        ops.fnv1a64_chunks = timed
        return self

    def __exit__(self, *exc):
        self._ops.fnv1a64_chunks = self._fn

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


def _npy_bytes(shape) -> int:
    """The bytes of a float32 array of ``shape`` as ``np.save`` writes it."""
    import io
    import math

    import numpy as np
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": np.lib.format.dtype_to_descr(np.dtype(np.float32)),
        "fortran_order": False, "shape": tuple(shape)})
    return buf.tell() + 4 * math.prod(shape)


def _verified_read_split(payload, card: str, reps: int = 5) -> dict:
    """One verified 24 MiB read (``Payload.verify`` on the card, as the
    client calls it) whole and in its parts, as ``chunk_digests`` takes
    them: the host copy of the bytes into a tensor, the copy to the card
    (pageable, synchronised), the kernel (CUDA events) and the digest's
    read back; host clock, the median of ``reps``."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels import fnv1a, ops
    parts = {k: [] for k in ("verify", "host copy", "to the card",
                             "kernel", "read back")}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not payload.verify("cuda"):
            raise AssertionError("weight leg: a cached chunk fails verify")
        parts["verify"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        buf = torch.empty(len(payload.data), dtype=torch.uint8)
        buf.numpy()[:] = np.frombuffer(payload.data, np.uint8)
        t1 = time.perf_counter()
        dev = buf.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ops.fnv1a64_chunks(dev, max(payload.size, 1))
        end.record()
        t3 = time.perf_counter()
        digest = fnv1a.unsigned(out)[0]
        t4 = time.perf_counter()
        if digest != payload.digest:
            raise AssertionError("weight leg: the split read's digest "
                                 "differs")
        parts["host copy"].append(t1 - t0)
        parts["to the card"].append(t2 - t1)
        parts["kernel"].append(start.elapsed_time(end) / 1e3)
        parts["read back"].append(t4 - t3)
    ms = {k: 1e3 * statistics.median(v) for k, v in parts.items()}
    say(f"weight leg, one verified read of {payload.size} B (median of "
        f"{reps}, host clock; the kernel by CUDA events): verify "
        f"{ms['verify']:.3f} ms = host copy into a tensor "
        f"{ms['host copy']:.3f} + copy to the card {ms['to the card']:.3f}"
        f" + kernel {ms['kernel']:.4f} + read back {ms['read back']:.3f} "
        f"(the launch's host work and the wait inside it)", card)
    return {"bytes": payload.size,
            **{k.replace(" the", "").replace(" ", "_") + "_ms": v
               for k, v in ms.items()}}


def phase_weight_leg(card: str, checked: dict) -> dict:
    """mamba2-780m at full width through the federation: its 48 layers'
    random bf16 weights (seed 0) saved by worker 0 in the reference's
    layout through the launcher's one-pod fleet, which digests on the
    card, drained to the origin, and restored by ``from_federation`` on
    worker 1: every leaf bit-exact, no checksum failure, stored bytes the
    ``.npy`` sizes and the manifest; a chunk corrupted in the pod cache
    before worker 2's restore is counted and refetched; engine C's
    requests give the same tokens on the restored engine as on one built
    from the weights in memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import AnalyticPlane, build_fleet_federation
    from repro_torch.models import init_lm, jax_layout
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import FederatedCheckpointer
    from repro_torch.train.checkpoint import _leaf_paths
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0, card)
    plane = AnalyticPlane(build_fleet_federation(num_pods=1, hosts_per_pod=4,
                                                 device="cuda"))
    state = jax_layout(params, cfg)
    shapes = [tuple(t.shape) for _, t in _leaf_paths(state)]
    _reset_counts()                          # the weight leg starts here
    with _DigestTimes() as digests:
        ck = FederatedCheckpointer("serve", plane, site="pod0", worker=0)
        t0 = time.perf_counter()
        saved = ck.save(0, state, drain=False)
        save_s = time.perf_counter() - t0
        store_launches, store_ms = _kernels()["fnv1a64_chunks"].launches, \
            digests.ms()
        t0 = time.perf_counter()
        drained = plane.drain()
        drain_s = time.perf_counter() - t0
        ck.stats.add(drained)
        drain_launches = _kernels()["fnv1a64_chunks"].launches - \
            store_launches
        drain_ms = digests.ms() - store_ms
        del state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = ServeEngine.from_federation(
            cfg, plane, "serve", site="pod0", worker=1, device="cuda",
            batch_size=ENGINE_C_BATCH, max_seq=1088)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_launches = _kernels()["fnv1a64_chunks"].launches - \
            store_launches - drain_launches
        restore_ms = digests.ms() - store_ms - drain_ms
    manifest = plane.fed.origins[0].meta(f"{ck.prefix(0)}/manifest.json")
    want_bytes = sum(_npy_bytes(s) for s in shapes) + manifest.size
    held = sum(m.size for m in plane.fed.origins[0].list_objects()
               if m.path.startswith(ck.prefix(0)))
    if not (saved.bytes == drained.bytes == held == want_bytes):
        raise AssertionError(f"weight leg: stored {saved.bytes} B, drained "
                             f"{drained.bytes}, origin {held}; the .npy "
                             f"sizes and the manifest {want_bytes}")
    pairs = list(zip(_leaves(engine.params), _leaves(params), strict=True))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        raise AssertionError("weight leg: a restored leaf differs from the "
                             "saved one")
    failures = plane.client("pod0", 1).stats.checksum_failures
    if failures:
        raise AssertionError(f"weight leg: {failures} checksum failures")
    stats = engine.data_stats
    rng = np.random.default_rng(0)
    lengths = engine_c_lengths(rng)

    def requests():
        return [Request(i, np.random.default_rng(10 + i).integers(
            0, cfg.vocab_size, int(n)), max_new_tokens=32)
            for i, n in enumerate(lengths)]
    served = requests()
    _drive("C from the federation (batch 4, max_seq 1088, 8 prompts of "
           "64-1000)", engine, served, "ssd_intra", checked, card)
    kernels = _kernels()                     # ... and ends here
    launches = kernels["fnv1a64_chunks"].launches
    designs = dict(kernels["fnv1a64_chunks"].launches_by_design)
    ssd = kernels["ssd_intra"].launches
    if not ssd or not designs["split"] or launches != store_launches + \
            drain_launches + restore_launches:
        raise AssertionError(f"the weight leg launched fnv1a64_chunks "
                             f"{launches} times (save, drain and restore "
                             f"{store_launches}, {drain_launches}, "
                             f"{restore_launches}; by design {designs}) "
                             f"and ssd_intra {ssd}")
    origin = plane.fed.origins[0]
    big = max(origin.list_objects(), key=lambda m: m.size)
    cache = plane.fed.caches["pod0/cache"]
    read = _verified_read_split(cache._lru[(big.path, 0)], card)
    # control: the middle chunk of the largest object corrupted in the pod
    # cache, then a fresh worker's restore
    bad = (big.path, big.num_chunks // 2)
    cache._lru[bad] = cache._lru[bad].corrupted()
    tree, again = FederatedCheckpointer("serve", plane, site="pod0",
                                        worker=2).restore(0, device="cuda")
    caught = plane.client("pod0", 2).stats.checksum_failures
    name = big.path[len(ck.prefix(0)) + 1:-len(".npy")]
    if caught != 1 or again.cache_misses != 1 or not torch.equal(
            tree[name], dict(_leaf_paths(jax_layout(params, cfg)))[name]):
        raise AssertionError(f"weight leg control: {caught} checksum "
                             f"failures, {again.cache_misses} misses after "
                             f"corrupting chunk {bad[1]} of {big.path}")
    del tree
    # the same requests on an engine built from the weights in memory
    in_memory = requests()
    ServeEngine(cfg, params, batch_size=ENGINE_C_BATCH,
                max_seq=1088).generate(in_memory)
    if [r.output for r in served] != [r.output for r in in_memory]:
        raise AssertionError("weight leg: the restored engine's tokens "
                             "differ from the in-memory engine's")
    gb = saved.bytes / 1e9
    say(f"weight leg mamba2-780m: {len(shapes)} leaves, {saved.bytes} B "
        f"stored (float32 .npy and the manifest) = Σ .npy sizes + manifest; "
        f"save {save_s:.2f} s ({gb / save_s:.3f} GB/s), drain "
        f"{drain_s:.2f} s ({gb / drain_s:.3f} GB/s), restore through "
        f"from_federation {restore_s:.2f} s ({gb / restore_s:.3f} GB/s) "
        f"(host clock); digest launches save {store_launches} "
        f"({store_ms:.1f} ms of kernel), drain {drain_launches} "
        f"({drain_ms:.1f} ms), restore {restore_launches} "
        f"({restore_ms:.1f} ms) (CUDA events); the leg's launches: "
        f"fnv1a64_chunks {launches} ({designs}), ssd_intra {ssd}; restore: "
        f"{stats.fetches} "
        f"fetches, {stats.chunks} chunks, hits {stats.cache_hits}, misses "
        f"{stats.cache_misses}; every leaf bit-exact, 0 checksum failures; "
        f"control: chunk {bad[1]} of {big.path} corrupted in the pod "
        f"cache, caught "
        f"{caught} time and refetched ({again.cache_misses} miss); engine C "
        f"from the federation and from memory give the same tokens; "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    return {"launches": launches, "ssd_launches": ssd,
            "launches_by_design": designs, "verified_read": read,
            "stored_bytes": saved.bytes, "save_s": save_s,
            "drain_s": drain_s, "restore_s": restore_s,
            "digest_launches": {"save": store_launches,
                                "drain": drain_launches,
                                "restore": restore_launches},
            "digest_ms": {"save": store_ms, "drain": drain_ms,
                          "restore": restore_ms}}


# ---------------------------------------------------------------------------
# qwen2-7b and the configs that need no new block: deepseek-coder-33b,
# phi3.5-moe, phi3-mini-3.8b (hd 96) and musicgen-medium (hd 64)
# ---------------------------------------------------------------------------
def _whole_groups(full, layers: int):
    return dataclasses.replace(full, num_layers=layers)


def _serve_config(card: str, checked: dict, arch: str, widths: Widths,
                  engines, *, layers: Optional[int] = None,
                  cut=_whole_groups, timed=(), ssd: Optional[dict] = None,
                  then=None, small_tol: float = 1e-4) -> dict:
    """One config's serving path: its smoke model card-vs-CPU in float32
    (``simt`` at hd 16, and at (P, N) = (16, 16) for SSM layers; for an
    MoE model with its routing compared), then ``arch`` at full width,
    ``cut(full, layers)`` deep where its weights would not fit the card at
    full depth (depth is the only cut), random bf16 weights from seed 0,
    through ``engines``: (label, batch, max_seq, prompt lengths, new
    tokens) each.  Every weight is bf16 on the card (the leaves the
    reference keeps in float32, an MoE router and an SSM's a_log, dt_bias
    and d_skip, float32), and ``init_lm`` holds at most one leaf's float32
    draw beside them; every flash launch of the path is ``wgmma`` at
    ``widths``; with ``ssd`` (its checked shapes) every ssd_intra launch
    is on the design ``DESIGNS`` names for the config's (P, N), at its
    widths.  ``then(cfg, params, card)`` runs after the path on the same
    weights; ``small_tol`` bounds the smoke model's logits.  Returns the
    path's flash and ssd_intra launches and what ``then`` returned."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import init_lm
    from repro_torch.models.convert import FLOAT32_LEAVES
    from repro_torch.serve import Request, ServeEngine

    simt_before = ssd_scan.KERNEL.launches_by_design["simt"]
    _check_small_model(dataclasses.replace(get_config(arch, smoke=True),
                                           dtype="float32"),
                       f"{arch} smoke, f32", card, small_tol)
    if ssd is not None and \
            ssd_scan.KERNEL.launches_by_design["simt"] == simt_before:
        raise AssertionError(f"{arch} smoke: no ssd_intra launch on simt")
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full if layers is None else cut(full, layers)
    # bytes requested by the code, not the allocator's blocks: a block
    # handed out whole may exceed its request by up to 1 MiB
    requested = "requested_bytes.all.{}"
    before = torch.cuda.memory_stats()[requested.format("current")]
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0, card)
    leaves = dict(_leaf_items(params))
    weight_bytes = sum(t.nbytes for t in leaves.values())
    wide = {name: str(t.dtype) for name, t in leaves.items()
            if t.dtype != torch.bfloat16
            and name.rsplit(".", 1)[-1] not in FLOAT32_LEAVES}
    largest = max(t.numel() for t in leaves.values())
    init_extra = torch.cuda.memory_stats()[requested.format("peak")] - \
        before - weight_bytes
    # one leaf's float32 draw, and 1 MiB for the generator's state
    if wide or init_extra > 4 * largest + 2 ** 20:
        raise AssertionError(f"{arch}: weights not bf16 {wide}, or init "
                             f"held {init_extra} B beyond the weights (one "
                             f"leaf in float32 is {4 * largest} B)")
    cut = (f"{cfg.num_layers} of {full.num_layers} layers (depth only)"
           if layers is not None else f"all {cfg.num_layers} layers")
    pads = f" padded to {cfg.padded_heads}" if cfg.padded_heads else ""
    experts, routers = "", ""
    if cfg.num_experts:
        experts = (f", {cfg.num_experts} experts, top-"
                   f"{cfg.experts_per_token}")
        routers = " but the routers (float32)"
    if ssd is not None:
        experts += (f", SSM H {cfg.ssm_heads} P {cfg.ssm_headdim} N "
                    f"{cfg.ssm_state} chunk {cfg.ssm_chunk}")
        routers = " but the routers and the SSM's a_log, dt_bias and " \
            "d_skip (float32)"
    say(f"{arch}: {cut}; d={cfg.d_model}, {cfg.num_heads} q-heads{pads} "
        f"over {cfg.num_kv_heads} KV heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}{experts}, vocab {cfg.vocab_size}; weights "
        f"{weight_bytes} bytes, all bf16{routers}; init held {init_extra} B "
        f"beyond them at its peak (the largest leaf's float32 draw is "
        f"{4 * largest} B)", card)

    rng = np.random.default_rng(0)
    runs = [(label, ServeEngine(cfg, params, batch_size=batch,
                                max_seq=max_seq),
             [Request(i, rng.integers(0, cfg.vocab_size, int(n)),
                      max_new_tokens=new) for i, n in enumerate(lengths)])
            for label, batch, max_seq, lengths, new in engines]
    ServeEngine(cfg, params, batch_size=4, max_seq=512).generate(
        [Request(-1, rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)])

    also = None if ssd is None else {"ssd_intra": ssd}
    _reset_counts()                          # the path starts here
    shapes, ssd_shapes = [], []
    for label, engine, reqs in runs:
        run = _drive(label, engine, reqs, "flash_attention", checked, card,
                     timed, also)
        shapes += run["shapes"]
        ssd_shapes += run["shapes_by_op"].get("ssd_intra", [])
    kernels = _kernels()                     # ... and ends here
    flash, ssd_kernel = kernels["flash_attention"], kernels["ssd_intra"]
    launches, by_design = flash.launches, dict(flash.launches_by_design)
    ssd_launches = ssd_kernel.launches
    ssd_by_design = dict(ssd_kernel.launches_by_design)
    decode_bound_ms, _ = _bound(0, 1.0, weight_bytes)
    ssd_line = "" if ssd is None else (
        f"; ssd_intra launches {ssd_launches} by design {ssd_by_design} at "
        f"{sorted(set(ssd_shapes))}")
    say(f"serve {arch}: flash launches {launches} by design {by_design} at "
        f"{sorted(set(shapes))}{ssd_line}; a decode step reading every "
        f"weight once {decode_bound_ms:.2f} ms at 3.35 TB/s; "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    want = f" H{widths.h} KV{widths.kv} hd{widths.hd}"
    if not launches or by_design["wgmma"] != launches or \
            not all(s.endswith(want) for s in shapes):
        raise AssertionError(f"the {arch} path sent flash launches to other "
                             f"designs or widths than wgmma at{want}, or "
                             f"none: {by_design}, {shapes}")
    if ssd is None and ssd_launches:
        raise AssertionError(f"the {arch} path launched ssd_intra")
    if ssd is not None:
        p, n = cfg.ssm_headdim, cfg.ssm_state
        design = ssd_scan.DESIGNS[(p, n)]
        if not ssd_launches or ssd_by_design[design] != ssd_launches or \
                not all(s.endswith(f" H{cfg.ssm_heads} P{p} N{n}")
                        for s in ssd_shapes):
            raise AssertionError(f"the {arch} path sent ssd_intra launches "
                                 f"to other designs or widths than {design} "
                                 f"at ({p}, {n}), or none: {ssd_by_design}, "
                                 f"{ssd_shapes}")
    return {"flash": launches, "ssd_intra": ssd_launches,
            "then": then(cfg, params, card) if then else None}


def _engine_a(label: str):
    """Engine A's shape: batch 4, max_seq 512, its 8 prompts of 64-256
    tokens, 32 new tokens each."""
    import numpy as np
    return (f"A on {label} (batch 4, max_seq 512, 8 prompts of 64-256)",
            ENGINE_A_BATCH, 512,
            engine_a_lengths(np.random.default_rng(0)), 32)


def phase_serve_qwen2(card: str, checked: dict) -> int:
    """qwen2-7b at full width (28 layers, 15.4 GB of random bf16 weights)
    in engine A's shape; every flash launch on ``wgmma`` at hd 128, its
    28 q-heads padded to 32 over 4 KV."""
    return _serve_config(card, checked, "qwen2-7b", QWEN2,
                         [_engine_a("qwen2-7b")])["flash"]


def phase_serve_deepseek(card: str, checked: dict) -> int:
    """deepseek-coder-33b at full width and full depth (62 layers, 68.5 GB
    of random bf16 weights) in engine A's shape; every flash launch on
    ``wgmma`` at hd 128, its 56 q-heads padded to 64 over 8 KV."""
    return _serve_config(card, checked, "deepseek-coder-33b", DEEPSEEK,
                         [_engine_a("deepseek-coder-33b")])["flash"]


def phase_serve_phi35_moe(card: str, checked: dict) -> int:
    """phi3.5-moe, 24 of its 32 layers (``PHI35_LAYERS``; the whole model's
    83.7 GB of bf16 weights do not fit the card; 24 layers are 62.9 GB),
    every width the published one, in engine E's shape (engine A's on the
    MoE model), with the MoE layer's, its routing's and its expert
    products' share of each wave and decode step."""
    from repro_torch.models import moe
    timed = ((moe, "moe_forward", None), (moe, "route", None),
             (moe, "expert_ffn", _expert_flops))
    label, *shape = _engine_a("phi3.5-moe")
    return _serve_config(card, checked, "phi3.5-moe-42b-a6.6b", PHI35_MOE,
                         [(label.replace("A on", "E on"), *shape)],
                         layers=PHI35_LAYERS, timed=timed)["flash"]


def phase_serve_phi3_mini(card: str, checked: dict) -> int:
    """phi3-mini-3.8b at full width (32 layers, 7.6 GB) in engine A's shape
    and one 4,000-token prompt with 8 new tokens; every flash launch on
    ``wgmma`` at hd 96 (32 q-heads over 32 KV)."""
    return _serve_config(card, checked, "phi3-mini-3.8b", PHI3_MINI, [
        _engine_a("phi3-mini-3.8b"),
        (f"long prompt on phi3-mini-3.8b (batch 1, max_seq 4096, one "
         f"prompt of {PHI3_MINI_PROMPT})", 1, 4096, [PHI3_MINI_PROMPT],
         8)])["flash"]


def phase_serve_musicgen(card: str, checked: dict) -> int:
    """musicgen-medium at full width (48 layers, 3.6 GB) over frame ids of
    its 2,048-entry codebook (the EnCodec front end is a stub, as in the
    reference) in engine A's shape and one prompt of 1,500 frames (30 s
    at 50 Hz) with 8 new tokens; every flash launch on ``wgmma`` at hd 64
    (24 q-heads over 24 KV)."""
    return _serve_config(card, checked, "musicgen-medium", MUSICGEN, [
        _engine_a("musicgen-medium"),
        (f"long prompt on musicgen-medium (batch 1, max_seq 1536, one "
         f"prompt of {MUSICGEN_PROMPT} frames)", 1, 1536, [MUSICGEN_PROMPT],
         8)])["flash"]


def phase_serve_jamba(card: str, flash_checked: dict,
                      ssd_checked: dict) -> dict:
    """jamba-1.5-large's hybrid stack: its smoke model card-vs-CPU (routing
    compared, ssd_intra on ``simt`` at (16, 16)), then its first
    ``JAMBA_LAYERS`` layers at full width (``depth_cut``: SSM+dense,
    SSM+MoE, SSM+dense, SSM+MoE, attention+dense, each block kind once;
    one 8-layer group is 90.3 GB of bf16, more than the card holds) in
    engine A's shape and one prompt of 8,000 tokens (32 whole chunks of
    256) with 8 new tokens; every ssd_intra launch on ``wgmma_p128`` at
    (H, P, N) = (128, 128, 128), every flash launch on ``wgmma`` at H64
    KV8 hd128, with the MoE layers' shares of each wave and step."""
    from repro_torch.configs import depth_cut
    from repro_torch.models import moe
    timed = ((moe, "moe_forward", None), (moe, "route", None),
             (moe, "expert_ffn", _expert_flops))
    arch = "jamba-1.5-large-398b"
    return _serve_config(card, flash_checked, arch, JAMBA, [
        _engine_a(arch),
        (f"long prompt on {arch} (batch 1, max_seq 8192, one prompt of "
         f"{ENGINE_D_PROMPT})", 1, 8192, [ENGINE_D_PROMPT], 8)],
        layers=JAMBA_LAYERS, cut=depth_cut, timed=timed, ssd=ssd_checked)


def _xattn_check(cfg, params, card: str) -> dict:
    """The real cross-attention at full width, outside the engine (whose
    requests carry no image, as the reference's engine's do):
    ``forward_with_cache`` on 2 prompts of 256 tokens with image states
    (2, 1600, 8192) in bf16 from seed 0, then 8 teacher-forced
    ``decode_step``s with the same states.  With every gate at its init of
    0 the logits equal, bit for bit, those of the same prompts with a
    blank image (zero states: an image that carries nothing); with every
    gate at 0.5 they differ (the control).  The counts are set to 0 before
    it and read after: every flash launch is one of the 28 self-attention
    layers' prefills, on ``wgmma``."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, forward_with_cache
    from repro_torch.models.model import layer_specs
    gates = [bp["mixer"]["gate"] for bp in params["blocks"]
             if "gate" in bp["mixer"]]
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (2, XATTN_PROMPT + XATTN_STEPS)),
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    image = torch.randn((2, IMAGE_TOKENS, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
    blank = torch.zeros_like(image)
    times = {}

    def run(states):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, _ = forward_with_cache(
            params, tokens[:, :XATTN_PROMPT], cfg,
            max_seq=XATTN_PROMPT + XATTN_STEPS, image_embeds=states)
        out = [logits]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(XATTN_STEPS):
            pos = XATTN_PROMPT + i
            step, cache = decode_step(params, cache, tokens[:, pos], pos, cfg,
                                      image_embeds=states)
            out.append(step)
        torch.cuda.synchronize()
        times.setdefault("prefill_ms", 1e3 * (t1 - t0))
        times.setdefault("decode_step_ms",
                         1e3 * (time.perf_counter() - t1) / XATTN_STEPS)
        if not all(bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError("cross-attention: non-finite logits")
        return out

    _reset_counts()                          # the cross-attention path
    torch.cuda.reset_peak_memory_stats()
    at_zero = [run(image), run(blank)]
    for g in gates:
        g.fill_(0.5)
    at_half = [run(image), run(blank)]
    for g in gates:
        g.zero_()
    flash = _kernels()["flash_attention"]    # ... and ends here
    launches, by_design = flash.launches, dict(flash.launches_by_design)
    self_layers = sum(s.mixer == "attn" for s in layer_specs(cfg))
    equal = all(torch.equal(a, b) for a, b in zip(*at_zero, strict=True))
    diff = max((a - b).abs().max().item()
               for a, b in zip(*at_half, strict=True))
    say(f"cross-attention {cfg.name} ({len(gates)} xattn layers of "
        f"{cfg.num_layers}; 2 prompts of {XATTN_PROMPT}, image states "
        f"(2, {IMAGE_TOKENS}, {cfg.d_model}) bf16, {XATTN_STEPS} decode "
        f"steps): gates 0, image vs blank logits bit-equal={equal}; gates "
        f"0.5, max |image - blank| logits={diff:.4e}; prefill_ms="
        f"{times['prefill_ms']:.2f} decode_step_ms="
        f"{times['decode_step_ms']:.2f} (host clock, with the image); flash "
        f"launches {launches} by design {by_design}; max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", card)
    if not equal:
        raise AssertionError("cross-attention: at gates 0 the image changed "
                             "the logits")
    if not diff > 0:
        raise AssertionError("cross-attention: at gates 0.5 the image did "
                             "not change the logits; the check cannot see "
                             "the image")
    if launches != 4 * self_layers or by_design["wgmma"] != launches:
        raise AssertionError(f"cross-attention: flash launches {by_design}, "
                             f"not 4 prefills of {self_layers} "
                             f"self-attention layers on wgmma")
    return {"launches": launches, "gate_half_max_diff": diff, **times}


def phase_serve_llama(card: str, checked: dict) -> dict:
    """llama-3.2-vision-90b, ``LLAMA_LAYERS`` of its 100 layers (7 whole
    groups of 5, 7 of them cross-attention; 64.10 GB of bf16) in engine
    A's shape, every flash launch on ``wgmma`` at H64 KV8 hd128, the
    cross-attention layers included (with no image they run as
    self-attention, as the reference's engine serves them); then the real
    cross-attention on the same weights (``_xattn_check``)."""
    return _serve_config(card, checked, "llama-3.2-vision-90b", LLAMA,
                         [_engine_a("llama-3.2-vision-90b")],
                         layers=LLAMA_LAYERS, then=_xattn_check,
                         small_tol=LLAMA_SMOKE_TOL)


def phase_launcher(card: str) -> None:
    """``repro_torch.launch.serve.main`` at the reference's defaults on the
    card: its two lines, in the reference's format."""
    import contextlib
    import io
    import re

    from repro_torch.launch.serve import main as serve_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_main([])
    lines = out.getvalue().splitlines()
    if rc != 0 or len(lines) != 2 or not re.fullmatch(
            r"weights via federation: [0-9.]+ MB, hits=\d+ misses=\d+",
            lines[0]) or lines[1] != ("served 6 requests: 8 prefills, 22 "
                                      "decode steps, 66 tokens"):
        raise AssertionError(f"launcher: exit {rc}, lines {lines}")
    for line in lines:
        say(f"launch.serve (gemma2-2b smoke, f32, on the card): {line}", card)


# ---------------------------------------------------------------------------
# Training: flash attention's backward, the training phases, the
# launcher with a restart
# ---------------------------------------------------------------------------
# (B, S, widths, window, dtype): the training paths' shapes on the wgmma
# design (qwen2-7b, phi3-mini-3.8b and musicgen-medium at global batch 4
# of 1,024 tokens; gemma2-2b at 1 of 8,192, where its local layers' window
# of 4,096 acts, with its softcap), then the smoke configs' float32 at hd
# 16 (simt) with a window and with a softcap
BWD_CASES = [(4, 1024, QWEN2, 0, "bfloat16"),
             (1, 8192, GEMMA2, 4096, "bfloat16"),
             (4, 1024, PHI3_MINI, 0, "bfloat16"),
             (4, 1024, MUSICGEN, 0, "bfloat16"),
             (4, 256, Widths(4, 2, 16, 0.0), 48, "float32"),
             (4, 256, Widths(4, 2, 16, 30.0), 0, "float32")]


def bwd_name(b: int, s: int, w: Widths, window: int, dtype: str) -> str:
    return case_name(w, b, s, window, dtype) + \
        (f" softcap{w.softcap:g}" if w.softcap else "")


BWD_MAIN_CASE = bwd_name(4, 1024, QWEN2, 0, "bfloat16")
BWD_NUDGE = 1e-2          # the control: dO moved by 1e-2 of its scale
# the training phases at full width: (arch, layers, batch, seq, steps).
# qwen2-7b's first 8 of 28 layers (2.98 B parameters; all 28 would need 93
# GB of state before any activation); gemma2-2b at one sequence of 8,192
# tokens, the only length here at which its local layers' window (4,096)
# acts, and its first 16 of 26 layers (8 local/global pairs): all 26 ran
# out of the card's 80 GB in the first step, whose float32 logits of
# 8,192 x 256,000 take 8.4 GB a tensor; phi3-mini-3.8b and
# musicgen-medium at all their layers (PERF.md §4 reckons the peaks);
# mamba2-780m at all 48 layers (0.78 B parameters, ~9.4 GB of state);
# jamba-1.5-large's first 1 of 72 layers, an SSM mixer at its real widths
# (H 128, P 128, N 128) with a dense FFN (2.08 B parameters, ~25 GB of
# state): its second layer adds a 16-expert MoE layer and 12.2 B
# parameters, which do not fit, and the cut exists to run the (128, 128)
# backward in training; mixtral-8x22b's first 1 of 56 layers (~2.9 B
# parameters, ~35 GB of state), so that the MoE layer's scatter, expert
# products and combine run under autograd on the card
TRAIN_PHASES = (("qwen2-7b", 8, 4, 1024, 6),
                ("gemma2-2b", 16, 1, 8192, 2),
                ("phi3-mini-3.8b", 32, 4, 1024, 2),
                ("musicgen-medium", 48, 4, 1024, 2),
                ("mamba2-780m", 48, 4, 1024, 2),
                ("jamba-1.5-large-398b", 1, 4, 1024, 2),
                ("mixtral-8x22b", 1, 4, 1024, 2))
# one step through the kernels against the same step with attention_ref on
# the card.  The random init (the reference's fan-in of a 3-D weight is its
# head count: wq comes out sqrt(d_model / heads) too large, wk and wv
# sqrt(d_model / KV heads)) gives scores of std ~200 at qwen2-7b: every row
# puts its weight on one key, near-ties decide, and the step moves with
# the order of any float32 sum (qwen2-7b's grad norm moved 42% with the
# plain version summed in reverse, 28% through SDPA, 91% with the
# attention in float64; kernel_probe.py train).  So the check step runs
# with each attention layer's wq, wk, wv and wo rescaled to their true
# fan-in (``ConditionedAttention``; scores of std ~0.7) and the run itself
# on the init as drawn.  The loss is held to 2e-3, the grad norm to 2e-2 or
# twice the reversed plain step's distance from the plain step, measured
# in the same run, whichever is larger, and each attention projection's
# gradient (wq, wk, wv, wo of every layer) to ``TRAIN_ATTN_GRAD_TOL`` of
# its largest element from the plain step's (bf16 gradients: the plain
# step summed in reverse lands up to 2.9e-2 away); a control, the same
# step with the backward's dK of each sequence's first 128 keys (one dK/dV
# block, the keys every causal row sees) dropped, must fall outside it
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2e-3, 2e-2
TRAIN_ATTN_GRAD_TOL = 5e-2
TRAIN_CONTROL_KEYS = 128
# an SSM layer's check: the step through the kernels against the same step
# with ``ssd_intra_ref`` on the card (``_PlainSSD``), each SSM layer's
# in_x, in_b, in_c, in_dt and a_log gradient within TRAIN_SSM_GRAD_TOL of
# its largest element; the control, the backward's dcum without its −j
# term (``_DroppedDecayEnd``), must fall outside it.  The check step runs
# on a float32 copy of the bf16 init: in bf16 the B and C leaves'
# gradients (sums over the tokens that mostly cancel, of dB and dC rounded
# to bf16 where the SSM casts its inputs up) move with any float32
# reordering of the SSD, by 2.7 of their largest element at mamba2-780m's
# 48 layers on 4 x 1,024 tokens (the plain step summed in reverse, or
# with the intra term in float64, as much as the kernels'), 1.8e-2–2.0e-2
# at its first 4 layers on 256 tokens; in float32 by 2.0e-5–3.4e-5 there
# and 3.5e-4–6.4e-4 at all 48 (``kernel_probe.py ssm``, H100 80GB HBM3,
# 700 W).  The tolerance is about three times the float32 spread at 48
# layers; a backward that lost one head's share of dS (1/48) is ten times
# past it
TRAIN_SSM_GRAD_TOL = 2e-3
SSM_LEAVES = ("in_x", "in_b", "in_c", "in_dt", "a_log")
# the smoke model's 10 float32 steps, card against CPU (TF32 off): the
# first 3 losses within 1e-5 (float32 sums in other orders); all 10 within
# 1e-3, since the run itself is that sensitive through Adam's normalised
# steps: the card's reordered sums moved step 10's loss by 2.3e-4–3.4e-4
# (PR 30), and the phase reports what one leaf moved by 1e-7 of itself
# does to it on a CPU alone
SMALL_TRAIN_TOL = (1e-5, 1e-3)
REPLAY_RTOL, REPLAY_ATOL = 1e-5, 1e-6     # the reference's own test
LAUNCH_LINE = (r"arch=qwen2-7b-smoke steps=30 loss (\d+\.\d{3})→"
               r"(\d+\.\d{3}) restarts=%d hit_rate=(\d\.\d\d)")


def _visible_pairs(s: int, window: int) -> int:
    return sum(r - (max(0, r - window + 1) if window else 0) + 1
               for r in range(s))


def phase_flash_backward(card: str) -> dict:
    """The backward kernel against ``attention_bwd_ref`` on the card, dq,
    dk and dv within ``ref.err_over_tolerance`` (one bf16 ulp + 1e-3 in
    bf16, 1e-4 in float32), with a control (dO moved by 1e-2 of its
    scale) that must fall outside it; the forward's lse against the plain
    version's.  Kernel ms (CUDA events), the plain version's, the library
    yardstick (autograd backward through SDPA on the same inputs, where
    one call computes the same function) and the bound: 10·hd FLOPs a
    visible pair at the type's peak, or the bytes of q, k, v, o, dO, lse
    in and dq, dk, dv out."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import BACKWARD, KERNEL

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, w, window, dtype_name in BWD_CASES:
        dtype = getattr(torch, dtype_name)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device="cuda")
                    ).to(dtype)
        q, k, v = rand(b, s, w.h, w.hd, scale=2.0), rand(b, s, w.kv, w.hd), \
            rand(b, s, w.kv, w.hd)
        dout = rand(b, s, w.h, w.hd)
        kw = dict(causal=True, window=window, softcap=w.softcap)
        o, lse = KERNEL.with_lse(q, k, v, **kw)
        _, lse_want = ref.attention_lse_ref(q, k, v, **kw)
        got = BACKWARD(q, k, v, dout, lse, **kw)
        want = ref.attention_bwd_ref(q, k, v, dout, lse, **kw)
        nudge = dout.float() + BWD_NUDGE * dout.float().std() * torch.randn(
            dout.shape, generator=gen, device="cuda")
        control = BACKWARD(q, k, v, nudge.to(dtype), lse, **kw)
        torch.cuda.synchronize()
        name = bwd_name(b, s, w, window, dtype_name)
        lse_err = (lse - lse_want).abs().max().item()
        ratio = max(ref.err_over_tolerance(g, x) for g, x in zip(got, want))
        control_ratio = max(ref.err_over_tolerance(c, x)
                            for c, x in zip(control, want))
        err = max((g.float() - x.float()).abs().max().item()
                  for g, x in zip(got, want))
        if not (ratio <= 1.0 and lse_err <= 2e-4):
            raise AssertionError(f"backward {name}: error {ratio} times the "
                                 f"tolerance {TOLERANCE[dtype_name]}, lse "
                                 f"{lse_err}")
        if not control_ratio > 1.0:
            raise AssertionError(f"backward {name}: the nudged-dO control is "
                                 f"within tolerance ({control_ratio})")
        iters = 10 if s >= 1024 else 50
        kernel_ms = time_ms(lambda: BACKWARD(q, k, v, dout, lse, **kw),
                            iters)
        plain_ms = time_ms(lambda: ref.attention_bwd_ref(
            q, k, v, dout, lse, **kw), 3)
        library_ms = None
        if not w.softcap:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask = None
            if window:
                i = torch.arange(s, device="cuda")
                mask = (i[None, :] <= i[:, None]) & \
                    (i[None, :] > i[:, None] - window)
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            grad_out = dout.transpose(1, 2)
            library_ms = time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), grad_out, retain_graph=True), iters)
        pairs = b * w.h * _visible_pairs(s, window)
        flops = 10 * w.hd * pairs
        nbytes = 2 * (q.nbytes + k.nbytes) + 2 * k.nbytes + dout.nbytes + \
            lse.nbytes                       # q, k, v, dO, lse in; dq, dk, dv out
        bound_ms, bound_by = _bound(flops, PEAK_FLOPS[dtype_name], nbytes)
        design = BACKWARD.design(dtype, w.hd)
        results[name] = dict(max_abs_err=err, err_over_tol=ratio,
                             control_err_over_tol=control_ratio,
                             lse_max_abs_err=lse_err, ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             tflops=flops / kernel_ms / 1e9, design=design)
        lib = "n/a (no library call takes the softcap)" if library_ms is \
            None else f"{library_ms:.4f} (autograd through sdpa)"
        say(f"kernel flash backward {name} ({design} design): "
            f"max_abs_err={err:.3e} err/tol={ratio:.3f} nudged-dO control "
            f"err/tol={control_ratio:.3f} (tol {TOLERANCE[dtype_name]}) "
            f"lse_err={lse_err:.2e} kernel_ms={kernel_ms:.4f} "
            f"({flops / kernel_ms / 1e9:.1f} TFLOP/s at 10 hd a pair) "
            f"plain_ms={plain_ms:.4f} library_ms={lib} "
            f"bound_ms={bound_ms:.4f} ({bound_by})", card)
        del q, k, v, o, lse, dout, got, want, control, nudge
        torch.cuda.empty_cache()
    return results


# ssd_intra's backward: every shape of ``ssd_cases()`` and the training
# shapes of mamba2-780m and jamba-1.5-large (4 x 1,024 tokens: 4 chunks of
# 256).  Each output is held to the plain version in float64 on the card
# within SSD_BWD_TOL of its largest magnitude: the plain version in
# float32 lies 3.0e-7–6.8e-7 from float64 there on an H100 (the phase
# measures and prints it at every case), and the kernel sums the same
# float32 products in other orders
SSD_BWD_TOL = 1e-5
SSD_BWD_TRAIN_CASES = [(4, 4, 256, 48, 64, 128), (4, 4, 256, 128, 128, 128)]
SSD_BWD_MAIN_CASE = "B4 NC4 Q256 H48 P64 N128"      # mamba2-780m training
SSD_BWD_P128_CASE = "B4 NC4 Q256 H128 P128 N128"    # jamba's SSM training
SSD_BWD_NAMES = ("dx", "ddt", "dcum", "db", "dc")


def _off(got, want) -> float:
    """|got − want|'s largest element over want's largest magnitude."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def phase_ssd_backward(card: str) -> dict:
    """The backward kernel against ``ssd_intra_bwd_ref`` in float64 on the
    card, at every shape of ``ssd_cases()`` and the training shapes, on
    ``phase_ssd_kernel``'s inputs (dt and the per-row log-decay softplus
    of a normal: exp overflows above the diagonal) and a normal dy: every
    output finite and within ``SSD_BWD_TOL`` of its largest magnitude,
    beside the float32 plain version's own distance; two controls that
    must fall outside it (dcum without its −j term, which is dt·ddt; dy
    moved by 1e-2 of its scale); a second launch bit-equal.  Kernel ms
    (CUDA events), the float32 plain version's, and the bound: Q(Q+1)/2 ·
    (6N + 4HP) operations a (batch, chunk) on the fp32 CUDA cores, or the
    bytes of x, dt, cum, B, C, dy in and dx, ddt, dcum, dB, dC out.  No
    PyTorch call computes this function: library_ms is none."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import BACKWARD

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, nc, q, h, p, n in dict.fromkeys(ssd_cases() +
                                           SSD_BWD_TRAIN_CASES):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x, b_in, c_in = rand(b, nc, q, h, p), rand(b, nc, q, n), \
            rand(b, nc, q, n)
        dt = F.softplus(rand(b, nc, q, h))
        cum = torch.cumsum(-F.softplus(rand(b, nc, q, h)), dim=2)
        dy = rand(b, nc, q, h, p)
        args = (x, dt, cum, b_in, c_in, dy)
        name = ssd_name(b, nc, q, h, p, n)
        design = BACKWARD.design(p, n)
        by_design = BACKWARD.launches_by_design[design]
        got = BACKWARD(*args)
        again = BACKWARD(*args)
        if BACKWARD.launches_by_design[design] != by_design + 2:
            raise AssertionError(f"ssd_intra backward {name}: the launches "
                                 f"were not counted under {design}")
        want = ref.ssd_intra_bwd_ref(*(t.double() for t in args))
        plain = ref.ssd_intra_bwd_ref(*args)
        nudge = dy + BWD_NUDGE * dy.std() * torch.randn(
            dy.shape, generator=gen, device="cuda")
        nudged = BACKWARD(x, dt, cum, b_in, c_in, nudge)
        torch.cuda.synchronize()
        if not all(g.shape == w.shape and bool(torch.isfinite(g).all())
                   for g, w in zip(got, want)):
            raise AssertionError(f"ssd_intra backward {name}: non-finite or "
                                 f"misshapen outputs")
        offs = [_off(g, w) for g, w in zip(got, want)]
        plain_offs = [_off(g, w) for g, w in zip(plain, want)]
        dropped = _off(got[2] + dt * got[1], want[2])
        nudged_off = max(_off(g, w) for g, w in zip(nudged, want))
        equal = all(torch.equal(a, g) for a, g in zip(again, got))
        err = max((g.double() - w).abs().max().item()
                  for g, w in zip(got, want))
        if not (max(offs) <= SSD_BWD_TOL and equal):
            raise AssertionError(
                f"ssd_intra backward {name}: off float64 by "
                f"{dict(zip(SSD_BWD_NAMES, offs))} (tol {SSD_BWD_TOL:g} of "
                f"each output's largest magnitude); two launches equal: "
                f"{equal}")
        if not (dropped > SSD_BWD_TOL and nudged_off > SSD_BWD_TOL):
            raise AssertionError(f"ssd_intra backward {name}: a control is "
                                 f"within tolerance (dcum without −j "
                                 f"{dropped}, nudged dy {nudged_off})")
        iters = max(5, min(100, int(4e9 // (b * nc * q * q * h * p))))
        kernel_ms = time_ms(lambda: BACKWARD(*args), iters)
        plain_ms = time_ms(lambda: ref.ssd_intra_bwd_ref(*args),
                           max(2, iters // 10))
        flops = b * nc * q * (q + 1) // 2 * (6 * n + 4 * h * p)
        nbytes = sum(t.nbytes for t in args) + sum(t.nbytes for t in got)
        bound_ms, bound_by = _bound(flops, PEAK_FLOPS["float32"], nbytes)
        tflops = flops / kernel_ms / 1e9
        results[name] = dict(max_abs_err=err, err_over_tol=max(offs)
                             / SSD_BWD_TOL, offs=dict(zip(SSD_BWD_NAMES,
                                                          offs)),
                             plain_f32_off=max(plain_offs),
                             control_dcum_off=dropped,
                             control_nudged_off=nudged_off, bit_equal=equal,
                             ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by, tflops=tflops, design=design)
        say(f"kernel ssd_intra backward {name} float32 ({design} design): "
            f"off float64 by {max(offs):.2e} of an output's largest "
            f"magnitude (tol {SSD_BWD_TOL:g}; the float32 plain version "
            f"{max(plain_offs):.2e}), max_abs_err={err:.3e}; controls: "
            f"dcum without its −j term {dropped:.2e}, dy moved by "
            f"{BWD_NUDGE:g} of its scale {nudged_off:.2e}; two launches "
            f"bit-equal; kernel_ms={kernel_ms:.4f} ({tflops:.1f} TFLOP/s at "
            f"Q(Q+1)/2·(6N+4HP)) plain_ms={plain_ms:.4f} library_ms=none "
            f"bound_ms={bound_ms:.4f} ({bound_by}, fp32 CUDA cores)", card)
        del x, dt, cum, b_in, c_in, dy, args, got, again, want, plain
        del nudge, nudged
        torch.cuda.empty_cache()
    return results


def _train_loader(vocab: int, batch: int, seq: int, device: str):
    """The launcher's data path: a two-pod fleet of 8 hosts each
    (``fleet(2, 8)``), 16 synthetic shards of 65,536 tokens at the origin,
    a ``FederatedDataLoader`` on pod0 through the analytic plane."""
    from repro_torch.core import AnalyticPlane, build_fleet_federation
    from repro_torch.data import (DatasetSpec, FederatedDataLoader,
                                  SyntheticTokens)
    fed = build_fleet_federation(num_pods=2, hosts_per_pod=8, device=device)
    spec = DatasetSpec("launch", vocab_size=vocab, tokens_per_shard=1 << 16,
                       num_shards=16)
    SyntheticTokens(spec).publish(fed.origins[0])
    return FederatedDataLoader(AnalyticPlane(fed), spec, global_batch=batch,
                               seq_len=seq, site="pod0", worker=0)


def plain_attention(order=None):
    """``ref.attention_ref``; with ``order``, the same function with each
    score's dot product summed in another order: "reverse" (q and k
    flipped along the head dim), or an int seeding a permutation of the
    head dim applied to q and k alike."""
    import torch

    from repro_torch.kernels import ref
    if order is None:
        return ref.attention_ref

    def reordered(q, k, v, **kw):
        hd = q.shape[-1]
        perm = torch.arange(hd - 1, -1, -1) if order == "reverse" else \
            torch.randperm(hd, generator=torch.Generator().manual_seed(order))
        perm = perm.to(q.device)
        return ref.attention_ref(q[..., perm], k[..., perm], v, **kw)
    return reordered


class _PlainAttention:
    """Routes the model's attention to ``plain_attention(order)`` on the
    card while the context is open (its gradient PyTorch's autograd), as
    ``_Routes`` reroutes the MoE layer's routing."""

    def __init__(self, order=None) -> None:
        self.order = order

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._flash = ops, ops.flash_attention
        ops.flash_attention = plain_attention(self.order)
        return self

    def __exit__(self, *exc):
        self._ops.flash_attention = self._flash


class _DroppedKeys:
    """While open, the backward kernel's dK of each sequence's first
    ``keys`` keys is zeroed after every launch: a backward that drops a
    dK/dV block, the training check's control."""

    def __init__(self, keys: int) -> None:
        self.keys = keys

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        self._fa, self._backward = fa, fa.BACKWARD
        keys, backward = self.keys, fa.BACKWARD

        def dropped(*args, **kw):
            dq, dk, dv = backward(*args, **kw)
            dk[:, :keys] = 0
            return dq, dk, dv
        fa.BACKWARD = dropped
        return self

    def __exit__(self, *exc):
        self._fa.BACKWARD = self._backward


def plain_ssd(order=None):
    """``ref.ssd_intra_ref``; with ``order="reverse"`` the same function
    with the scores' dot products summed in reverse (B and C flipped along
    the state dim)."""
    from repro_torch.kernels import ref
    if order is None:
        return ref.ssd_intra_ref

    def reordered(x, dt, cum, b_in, c_in):
        return ref.ssd_intra_ref(x, dt, cum, b_in.flip(-1), c_in.flip(-1))
    return reordered


class _PlainSSD:
    """Routes the SSM layers' ``ops.ssd_intra`` to ``plain_ssd(order)`` on
    the card while the context is open (its gradient PyTorch's autograd
    through the masked plain version)."""

    def __init__(self, order=None) -> None:
        self.order = order

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._ssd = ops, ops.ssd_intra
        ops.ssd_intra = plain_ssd(self.order)
        return self

    def __exit__(self, *exc):
        self._ops.ssd_intra = self._ssd


class _DroppedDecayEnd:
    """While open, the ssd_intra backward kernel's dcum loses its −j term
    (Σ_i T_ij, which is dt_j·ddt_j): a backward that forgets the decay's
    start, the SSM check's control."""

    def __enter__(self):
        from repro_torch.kernels import ssd_scan
        self._ssd, self._backward = ssd_scan, ssd_scan.BACKWARD
        backward = ssd_scan.BACKWARD

        def dropped(x, dt, cum, b_in, c_in, dy):
            dx, ddt, dcum, db, dc = backward(x, dt, cum, b_in, c_in, dy)
            return dx, ddt, dcum + dt * ddt, db, dc
        ssd_scan.BACKWARD = dropped
        return self

    def __exit__(self, *exc):
        self._ssd.BACKWARD = self._backward


class _HeldRoutes:
    """Holds every MoE layer's routing fixed across the check step's runs:
    the first run the context is opened for records each ``moe.route``
    call's (expert, slot, kept); later runs replay them in call order, with
    the gates recomputed from the current router's probabilities (so the
    router's gradient flows), and count the (token, choice) pairs whose own
    routing would have differed.  In bf16, top-2 near-ties otherwise route
    tokens apart between the plain and the kernel step."""

    def __init__(self) -> None:
        self.recorded, self.flipped = None, 0

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route
        record = self.recorded is None
        if record:
            self.recorded = []
        calls = iter(range(len(self.recorded)))

        def held(p, x, cfg):
            r = self._route(p, x, cfg)
            if record:
                self.recorded.append((r.expert, r.slot, r.kept))
                return r
            expert, slot, kept = self.recorded[next(calls)]
            self.flipped += int((r.expert != expert).sum())
            gates = r.probs.gather(-1, expert)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return r._replace(gates=gates, expert=expert, slot=slot,
                              kept=kept)
        moe.route = held
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def ssm_leaves(params, cfg):
    """(path, tensor) of every SSM layer's ``SSM_LEAVES``."""
    from repro_torch.models.model import layer_specs
    return [(("blocks", i, "mixer", name), block["mixer"][name])
            for i, (spec, block) in enumerate(zip(layer_specs(cfg),
                                                  params["blocks"]))
            if spec.mixer == "ssm" for name in SSM_LEAVES]


def attention_projections(params, cfg):
    """(path, tensor) of every self-attention layer's wq, wk, wv and wo."""
    from repro_torch.models.model import layer_specs
    return [(("blocks", i, "mixer", name), block["mixer"][name])
            for i, (spec, block) in enumerate(zip(layer_specs(cfg),
                                                  params["blocks"]))
            if spec.mixer.startswith("attn")
            for name in ("wq", "wk", "wv", "wo")]


class ConditionedAttention:
    """While open, each self-attention layer's wq, wk and wv are scaled in
    place to a fan-in of d_model and wo to one of its heads x head_dim
    inputs (the init takes a 3-D weight's second-to-last axis as its
    fan-in); on exit the weights are restored bit for bit."""

    def __init__(self, params, cfg) -> None:
        self.leaves = attention_projections(params, cfg)

    def __enter__(self):
        import torch
        self.saved = [t.detach().clone() for _, t in self.leaves]
        with torch.no_grad():
            for path, t in self.leaves:
                fan = t.shape[0] * t.shape[1] if path[-1] == "wo" else \
                    t.shape[0]
                t.mul_((t.shape[-2] / fan) ** 0.5)
        return self

    def __exit__(self, *exc):
        import torch
        with torch.no_grad():
            for (_, t), saved in zip(self.leaves, self.saved):
                t.copy_(saved)
        del self.saved


def _loss_and_grads(params, cfg, aux_weight: float, batch) -> tuple:
    """The loss of ``params`` on ``batch`` as the trainer takes it, its
    global gradient norm and the gradients of ``attention_projections``
    and of ``ssm_leaves``, without a step."""
    import torch

    from repro_torch.models import lm_loss
    from repro_torch.train.optimizer import global_norm, walk
    leaves = [t.requires_grad_(True) for _, t in walk(params)]
    loss, _ = lm_loss(params, torch.as_tensor(batch["tokens"], device="cuda"),
                      torch.as_tensor(batch["labels"], device="cuda"),
                      cfg, aux_weight=aux_weight)
    grads = torch.autograd.grad(loss, leaves)
    at = {id(t): g for t, g in zip(leaves, grads)}
    attn = [at[id(t)] for _, t in attention_projections(params, cfg)]
    ssd = [at[id(t)] for _, t in ssm_leaves(params, cfg)]
    return loss.item(), global_norm(grads).item(), attn, ssd


class _TrainTimes:
    """Times, while open, each train step on the host clock around
    synchronised work, and with CUDA events every flash forward launch,
    every flash backward launch, every ssd_intra forward and backward
    launch and every ``adamw_update``."""

    def __init__(self, trainer) -> None:
        self.trainer = trainer
        self.step_s = []
        self.events = {key: [] for key in ("forward", "backward",
                                           "ssd_forward", "ssd_backward",
                                           "optimizer")}

    def _timed(self, fn, key):
        def call(*args, **kw):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[key].append((start, end))
            return out
        return call

    def __enter__(self):
        import torch

        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan
        from repro_torch.train import trainer as trainer_mod
        self._fa, self._ssd, self._tm = fa, ssd_scan, trainer_mod
        self._backward, self._adamw = fa.BACKWARD, trainer_mod.adamw_update
        self._ssd_backward = ssd_scan.BACKWARD
        fa.KERNEL._launch = self._timed(fa.KERNEL._launch, "forward")
        fa.BACKWARD = self._timed(self._backward, "backward")
        ssd_scan.KERNEL._launch = self._timed(ssd_scan.KERNEL._launch,
                                              "ssd_forward")
        ssd_scan.BACKWARD = self._timed(self._ssd_backward, "ssd_backward")
        trainer_mod.adamw_update = self._timed(self._adamw, "optimizer")
        step = self.trainer.train_step

        def timed_step(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - t0)
            return out
        self.trainer.train_step = timed_step
        return self

    def __exit__(self, *exc):
        del self._fa.KERNEL._launch
        self._fa.BACKWARD = self._backward
        del self._ssd.KERNEL._launch
        self._ssd.BACKWARD = self._ssd_backward
        self._tm.adamw_update = self._adamw
        del self.trainer.train_step

    def ms(self, key: str, steps: int) -> float:
        """Milliseconds a step of the events under ``key``."""
        return sum(a.elapsed_time(b) for a, b in self.events[key]) / steps


def phase_train(card: str, arch: str, layers: int, batch: int, seq: int,
                steps: int) -> dict:
    """``arch`` at full width, its first ``layers`` layers (``depth_cut``;
    depth is the only cut), random bf16 weights from seed 0 and float32
    moments, trained by ``Trainer.run`` on a ``FederatedDataLoader`` over
    ``fleet(2, 8)``: global batch ``batch`` of ``seq`` tokens, ``steps``
    steps, no checkpointer.  First one step through the kernels against
    the same step with the plain versions on the card (``attention_ref``
    under ``ConditionedAttention``, ``ssd_intra_ref``), every MoE layer's
    routing held to the plain step's (``_HeldRoutes``): the loss, the grad
    norm, with the plain step summed in reverse for its spread, each
    attention projection's gradient with the dropped-keys control and each
    SSM layer's ``SSM_LEAVES`` gradients with the dropped-decay-end
    control, each control required to fail; then the run on the init as
    drawn, every loss finite, every flash launch ``wgmma`` (two an
    attention layer a step: forward and remat) and every flash backward
    ``wgmma`` (one an attention layer a step), every ssd_intra launch on
    the (P, N)'s design (two an SSM layer a step) and every ssd_intra
    backward on its backward design (one an SSM layer a step)."""
    import contextlib
    import math

    import torch

    from repro_torch.configs import depth_cut, get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models.model import layer_specs
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train.optimizer import walk

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = depth_cut(full, layers) if layers < full.num_layers else full
    specs = layer_specs(cfg)
    attn_layers = sum(spec.mixer.startswith("attn") for spec in specs)
    ssm_layers = sum(spec.mixer == "ssm" for spec in specs)
    moe_layers = sum(spec.ffn == "moe" for spec in specs)
    loader = _train_loader(cfg.vocab_size, batch, seq, "cuda")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, loader, AdamWConfig(warmup_steps=2,
                                               total_steps=100),
                      device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in walk(trainer.state["params"]))
    state_gb = sum(t.nbytes for _, t in walk(trainer.state)) / 1e9
    heads = cfg.padded_heads or cfg.num_heads
    kinds = ", ".join(f"{n} {kind}" for n, kind in (
        (attn_layers, "attention"), (ssm_layers, "SSM"), (moe_layers, "MoE"))
        if n)
    ssm_widths = (f", SSM H {cfg.ssm_heads} P {cfg.ssm_headdim} N "
                  f"{cfg.ssm_state} chunk {cfg.ssm_chunk}"
                  if ssm_layers else "")
    moe_widths = (f", {cfg.num_experts} experts top-{cfg.experts_per_token}"
                  if moe_layers else "")
    say(f"train {arch}: {cfg.num_layers} of {full.num_layers} layers "
        f"({'depth only' if layers < full.num_layers else 'no cut'}; "
        f"{kinds}), d={cfg.d_model}, {cfg.num_heads} q-heads"
        f"{f' padded to {heads}' if cfg.padded_heads else ''} over "
        f"{cfg.num_kv_heads} KV of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.sliding_window or 0}, softcap {cfg.attn_logit_softcap:g}"
        f"{ssm_widths}{moe_widths}; {n_params} parameters in {cfg.dtype}, "
        f"float32 moments: {state_gb:.2f} GB of state; init {init_s:.1f} s",
        card)

    first = loader.batch(0)
    params, check_cfg = trainer.state["params"], cfg
    if ssm_layers:           # the check step on a float32 copy of the init
        if attn_layers:
            raise ValueError(f"train {arch}: the float32 check step has no "
                             f"flash backward at hd {cfg.resolved_head_dim}")
        check_cfg = dataclasses.replace(cfg, dtype="float32")
        params = _tree_map(lambda t: t.detach().to(torch.float32, copy=True),
                           params)
    attn_paths = [p for p, _ in attention_projections(params, cfg)]
    ssm_paths = [p for p, _ in ssm_leaves(params, cfg)]

    def step():
        return _loss_and_grads(params, check_cfg, trainer.aux_weight, first)

    def off(grads, want):
        return [_off(g, w) for g, w in zip(grads, want)]

    def plain(order=None):
        stack = contextlib.ExitStack()
        stack.enter_context(_PlainAttention(order))
        stack.enter_context(_PlainSSD(order))
        return stack
    routes = _HeldRoutes()
    with ConditionedAttention(params, check_cfg):
        with plain(), routes:
            loss_p, gnorm_p, attn_p, ssm_p = step()
        with routes:
            loss_k, gnorm_k, attn_k, ssm_k = step()
        attn_off, ssm_off = off(attn_k, attn_p), off(ssm_k, ssm_p)
        del attn_k, ssm_k
        with plain("reverse"), routes:
            loss_r, gnorm_r, attn_r, ssm_r = step()
        attn_rev, ssm_rev = off(attn_r, attn_p), off(ssm_r, ssm_p)
        del attn_r, ssm_r
        attn_ctl = ssm_ctl = []
        if attn_layers:
            with _DroppedKeys(TRAIN_CONTROL_KEYS), routes:
                attn_ctl = off(step()[2], attn_p)
        if ssm_layers:
            with _DroppedDecayEnd(), routes:
                ssm_ctl = off(step()[3], ssm_p)
        del attn_p, ssm_p
    del params
    check_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    gnorm_rel = abs(gnorm_k - gnorm_p) / gnorm_p
    spread = abs(gnorm_r - gnorm_p) / gnorm_p
    gnorm_tol = max(TRAIN_GNORM_RTOL, 2 * spread)

    def worst(offs, paths):
        if not offs:
            return "none"
        i = max(range(len(offs)), key=offs.__getitem__)
        return f"{offs[i]:.3e} ({'.'.join(map(str, paths[i]))})"
    leaf_lines = []
    if attn_layers:
        leaf_lines.append(
            f"the {len(attn_paths)} attention projections' gradients off by "
            f"up to {worst(attn_off, attn_paths)} of their largest element "
            f"(tol {TRAIN_ATTN_GRAD_TOL:g}; summed in reverse "
            f"{max(attn_rev):.3e}; control, dK of the first "
            f"{TRAIN_CONTROL_KEYS} keys dropped: {max(attn_ctl):.3e})")
    if ssm_layers:
        leaf_lines.append(
            f"the {len(ssm_paths)} SSM leaves' gradients "
            f"({', '.join(SSM_LEAVES)}) off by up to "
            f"{worst(ssm_off, ssm_paths)} (tol {TRAIN_SSM_GRAD_TOL:g}; "
            f"the scores summed in reverse {max(ssm_rev):.3e}; control, "
            f"dcum without its −j term: {max(ssm_ctl):.3e})")
    say(f"train {arch}, one step through the kernels vs the plain versions "
        f"on the card{', the attention projections at their true fan-in' if attn_layers else ''}"
        f"{', in float32 (a copy of the init)' if ssm_layers else ''}"
        f"{f', routing held ({routes.flipped} (token, choice) pairs would have routed elsewhere)' if moe_layers else ''}: "
        f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, tol "
        f"{TRAIN_LOSS_RTOL:g}), grad norm {gnorm_k:.6e} vs {gnorm_p:.6e} "
        f"(rel {gnorm_rel:.2e}, tol {gnorm_tol:.2e}; plain summed in "
        f"reverse: loss rel {abs(loss_r - loss_p) / abs(loss_p):.2e}, grad "
        f"norm rel {spread:.2e}); {'; '.join(leaf_lines)}; peak "
        f"{check_gb:.2f} GB", card)
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= gnorm_tol and
            max(attn_off, default=0) <= TRAIN_ATTN_GRAD_TOL and
            max(ssm_off, default=0) <= TRAIN_SSM_GRAD_TOL):
        raise AssertionError(f"train {arch}: the kernels' step is off the "
                             f"plain versions'")
    if attn_layers and not max(attn_ctl) > TRAIN_ATTN_GRAD_TOL:
        raise AssertionError(f"train {arch}: the dropped-keys control is "
                             f"within tolerance ({max(attn_ctl)})")
    if ssm_layers and not max(ssm_ctl) > TRAIN_SSM_GRAD_TOL:
        raise AssertionError(f"train {arch}: the dropped-decay-end control "
                             f"is within tolerance ({max(ssm_ctl)})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()                          # the path starts here
    with _TrainTimes(trainer) as times:
        report = trainer.run(steps)
        torch.cuda.synchronize()
    kernels = _kernels()                     # ... and ends here
    fwd, bwd = kernels["flash_attention"], kernels["flash_attention_backward"]
    sfwd, sbwd = kernels["ssd_intra"], kernels["ssd_intra_backward"]
    launches = {"forward": fwd.launches,
                "forward_by_design": dict(fwd.launches_by_design),
                "backward": bwd.launches,
                "backward_by_design": dict(bwd.launches_by_design),
                "ssd_forward": sfwd.launches,
                "ssd_forward_by_design": dict(sfwd.launches_by_design),
                "ssd_backward": sbwd.launches,
                "ssd_backward_by_design": dict(sbwd.launches_by_design)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in report.losses) or \
            report.steps_run != steps:
        raise AssertionError(f"train {arch}: losses {report.losses}")
    want_fwd, want_bwd = 2 * attn_layers * steps, attn_layers * steps
    want_sfwd, want_sbwd = 2 * ssm_layers * steps, ssm_layers * steps
    widths = (cfg.ssm_headdim, cfg.ssm_state)
    sdesign = ssd_scan.DESIGNS.get(widths)
    sbdesign = ssd_scan.BACKWARD_DESIGNS.get(widths)
    if launches["forward"] != want_fwd or \
            launches["forward_by_design"]["wgmma"] != want_fwd or \
            launches["backward"] != want_bwd or \
            launches["backward_by_design"]["wgmma"] != want_bwd or \
            launches["ssd_forward"] != want_sfwd or \
            launches["ssd_backward"] != want_sbwd or \
            (ssm_layers and (
                launches["ssd_forward_by_design"][sdesign] != want_sfwd or
                launches["ssd_backward_by_design"][sbdesign] != want_sbwd)):
        raise AssertionError(
            f"train {arch}: launches {launches}; want {want_fwd} flash "
            f"forward and {want_bwd} backward, all on wgmma, {want_sfwd} "
            f"ssd_intra forward on {sdesign} and {want_sbwd} backward on "
            f"{sbdesign}")
    steady = times.step_s[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    tokens = batch * seq
    split = {key: times.ms(key, steps) for key in times.events}
    # the events are a step's average over every step, the first included
    rest_ms = 1e3 * sum(times.step_s) / steps - sum(split.values())
    out = dict(arch=arch, layers=cfg.num_layers, batch=batch, seq=seq,
               steps=steps, parameters=n_params, state_gb=state_gb,
               losses=report.losses, step_ms=step_ms,
               first_step_ms=1e3 * times.step_s[0],
               tokens_per_s=tokens / (step_ms / 1e3), peak_gb=peak_gb,
               check_peak_gb=check_gb, launches=launches,
               flash_forward_ms=split["forward"],
               flash_backward_ms=split["backward"],
               ssd_forward_ms=split["ssd_forward"],
               ssd_backward_ms=split["ssd_backward"],
               optimizer_ms=split["optimizer"], rest_ms=rest_ms,
               loss_rel=loss_rel, gnorm_rel=gnorm_rel,
               gnorm_reversed_rel=spread,
               attn_grad_off=max(attn_off, default=None),
               attn_grad_reversed_off=max(attn_rev, default=None),
               attn_grad_control_off=max(attn_ctl, default=None),
               ssm_grad_off=max(ssm_off, default=None),
               ssm_grad_reversed_off=max(ssm_rev, default=None),
               ssm_grad_control_off=max(ssm_ctl, default=None),
               routes_flipped=routes.flipped,
               hit_rate=report.cache_hit_rate,
               phase_s=time.perf_counter() - t_phase)
    say(f"train {arch}: {steps} steps of {batch} x {seq} tokens, losses "
        f"{[round(x, 4) for x in report.losses]} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f}); {step_ms:.2f} ms a step after "
        f"the first ({1e3 * times.step_s[0]:.1f} ms), "
        f"{out['tokens_per_s']:.0f} tokens/s; a step's flash forward "
        f"{split['forward']:.2f} ms ({want_fwd // steps} launches, wgmma: "
        f"forward and remat), flash backward {split['backward']:.2f} ms "
        f"({want_bwd // steps} launches, wgmma), ssd_intra forward "
        f"{split['ssd_forward']:.2f} ms ({want_sfwd // steps} launches, "
        f"{sdesign}), ssd_intra backward {split['ssd_backward']:.2f} ms "
        f"({want_sbwd // steps} launches, {sbdesign}), adamw_update "
        f"{split['optimizer']:.2f} ms, the rest {rest_ms:.2f} ms (the split "
        f"a step's average over all {steps}); loader hit "
        f"rate {report.cache_hit_rate:.2f}; max_memory_allocated "
        f"{peak_gb:.2f} GB; the phase {out['phase_s']:.1f} s", card)
    del trainer, loader, times
    return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.detach().to(device).clone()


# the small training runs, card against CPU: (smoke config, a leaf of
# layer 0's mixer the drift probe moves, the kernel whose backward runs)
SMALL_TRAINS = (("qwen2-7b", "wq", "flash_attention_backward"),
                ("mamba2-780m", "in_x", "ssd_intra_backward"))


def phase_train_small(card: str, arch: str, leaf: str, kernel: str) -> dict:
    """``arch``'s smoke model in float32, 10 ``Trainer`` steps on the card
    (the backward ``kernel`` on its ``simt`` design: flash at hd 16, or
    ssd_intra at (P, N) = (16, 16) and Q 8) and on the CPU (the plain path)
    from the same init and the same batches: the losses within
    ``SMALL_TRAIN_TOL``; beside them the CPU run's own drift when one leaf
    is moved by 1e-7 of itself."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train.optimizer import walk

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    trainers = {device: Trainer(cfg, _train_loader(cfg.vocab_size, 4, 64,
                                                   device),
                                AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=100), device=device)
                for device in ("cuda", "cpu")}
    init = _to_device(trainers["cuda"].state, "cpu")
    trainers["cpu"].state = _to_device(init, "cpu")
    # the yardstick of the run's own sensitivity: the CPU run again with
    # one leaf moved by 1e-7 of itself
    nudged = Trainer(cfg, _train_loader(cfg.vocab_size, 4, 64, "cpu"),
                     AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                     device="cpu")
    nudged.state = _to_device(init, "cpu")
    nudged.state["params"]["blocks"][0]["mixer"][leaf].mul_(1 + 1e-7)
    bwd = _kernels()[kernel]
    before = bwd.launches_by_design["simt"]
    losses = {d: t.run(10).losses for d, t in trainers.items()}
    drift = abs(nudged.run(10).losses[-1] - losses["cpu"][-1])
    errs = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
    early, err = max(errs[:3]), max(errs)
    params = {d: dict(walk(t.state["params"])) for d, t in trainers.items()}
    param_err = max((params["cuda"][p].detach().cpu() -
                     params["cpu"][p].detach()).abs().max().item()
                    for p in params["cpu"])
    launched = bwd.launches_by_design["simt"] - before
    say(f"train small ({arch} smoke, f32, 10 steps): card vs CPU losses "
        f"max_abs_err {early:.3e} over the first 3 steps (tol "
        f"{SMALL_TRAIN_TOL[0]:g}), {err:.3e} over all 10 (tol "
        f"{SMALL_TRAIN_TOL[1]:g}), per step {[f'{e:.1e}' for e in errs]}; "
        f"parameters {param_err:.3e}; on the CPU alone, {leaf} of layer 0 "
        f"moved by 1e-7 of itself moves step 10's loss by {drift:.3e}; "
        f"{launched} {kernel} launches on simt", card)
    if not (early <= SMALL_TRAIN_TOL[0] and err <= SMALL_TRAIN_TOL[1]) or \
            launched != cfg.num_layers * 10:
        raise AssertionError(f"train small {arch}: card vs CPU losses "
                             f"{losses}, {launched} {kernel} launches")
    return {"loss_err_first3": early, "loss_err": err,
            "param_err": param_err, "cpu_nudge_drift": drift,
            "launches": launched}


def phase_launcher_train(card: str) -> dict:
    """``repro_torch.launch.train.main`` on the card: at the reference's
    defaults, then with ``--grad-compression int8_ef --fail-at 20`` (a
    restart from the step-20 checkpoint), then the same without the
    failure.  Each prints the reference's line; the restarted run's final
    parameters, moments and residuals equal the uninterrupted one's within
    the reference test's rtol 1e-5, atol 1e-6; bit-equality is
    reported."""
    import contextlib
    import io
    import re

    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import walk
    made, original = [], launch_train.Trainer

    class Recording(original):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)
    launch_train.Trainer = Recording
    lines, seconds = [], []
    try:
        for argv, restarts in (([], 0),
                               (["--grad-compression", "int8_ef",
                                 "--fail-at", "20"], 1),
                               (["--grad-compression", "int8_ef"], 0)):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = launch_train.main(argv)
            seconds.append(time.perf_counter() - t0)
            line = out.getvalue().strip()
            if rc != 0 or not re.fullmatch(LAUNCH_LINE % restarts, line):
                raise AssertionError(f"launch.train {argv}: exit {rc}, "
                                     f"{line!r}")
            lines.append(line)
    finally:
        launch_train.Trainer = original
    got = dict(walk(made[1].checkpoint_state()))
    want = dict(walk(made[2].checkpoint_state()))
    worst, equal = 0.0, True
    for path, a in got.items():
        a, b = a.detach().float(), want[path].detach().float()
        equal &= torch.equal(a, b)
        excess = ((a - b).abs() - REPLAY_ATOL - REPLAY_RTOL * b.abs()).max()
        worst = max(worst, excess.item())
    for argv, line, sec in zip(("defaults", "int8_ef --fail-at 20",
                                "int8_ef"), lines, seconds):
        say(f"launch.train ({argv}, qwen2-7b smoke, f32, on the card, "
            f"{sec:.1f} s): {line}", card)
    say(f"launch.train: the restarted run's {len(got)} state leaves against "
        f"the uninterrupted run's: within rtol {REPLAY_RTOL:g}, atol "
        f"{REPLAY_ATOL:g}: {worst <= 0}; bit-equal: {equal}", card)
    if worst > 0:
        raise AssertionError("launch.train: the restart does not replay the "
                             "uninterrupted run")
    return {"bit_equal": equal, "seconds": seconds}


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

    # times: the kernel alone (inputs resident; CUDA events), the plain
    # version on the card (the torch-ops loop, host clock around
    # synchronised calls), the whole call as the simulator pays it and its
    # four parts, the plain version on the CPU, and the scalar solver
    F_p = maxmin._next_pow2(F)
    L_p = maxmin._next_pow2(L + 1)
    width = maxmin._next_pow2(max(len(r) for r in flow_links), floor=4)
    staging = maxmin.Staging(1, F_p, L_p, width, torch.device("cuda"))
    maxmin.pad_problem(link_caps, flow_links, flow_caps, F_p, L_p, width,
                       out=staging.problem(0))
    args = staging.views(staging.upload())
    kernel_ms = graph_ms(lambda: maxmin.WATERFILL(*args))
    card_plain = maxmin.plain_waterfill(*args)[0, :F].cpu().numpy()
    for f, row in enumerate(flow_links):
        if not row:                      # the host's loopback fix-up
            card_plain[f] = flow_caps[f]
    rel_plain = float(np.max(np.abs(card_rates - card_plain)
                             / np.maximum(np.abs(card_plain), 1e-30)))
    if rel_plain > MAXMIN_CPU_RTOL:
        raise AssertionError(f"H snapshot {label}: kernel vs the plain "
                             f"version on the card, max rel {rel_plain}")

    def host_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters
    plain_ms = host_ms(lambda: maxmin.plain_waterfill(*args), 20)
    call_ms = host_ms(lambda: maxmin.maxmin_rates_sparse(
        link_caps, flow_links, flow_caps, device="cuda"), 200)
    split = _call_split(problem, 200)
    cpu_ms = host_ms(lambda: maxmin.maxmin_rates_sparse(
        link_caps, flow_links, flow_caps, device="cpu"), 20)
    scalar_ms = min(1e3 * _scalar_rates(link_caps, flow_links, flow_caps)[1]
                    for _ in range(5))
    # the bound: the problem's bytes (the flows' link indices as int32,
    # the flow caps and the link caps read once, the rates written once)
    # at 3.35 TB/s, or the rounds' chain: per round four barriers and the
    # block's min (log2 of its threads shuffle steps), one clock each at
    # the maximum SM clock; the larger binds
    nnz = sum(len(r) for r in flow_links)
    solve_bytes = 4 * nnz + 4 * F + 4 * L + 4 * F
    bytes_ms = 1e3 * solve_bytes / HBM_BYTES_PER_S
    chain_steps = rounds * (3 + maxmin.WATERFILL.threads(F_p).bit_length())
    chain_ms = 1e3 * chain_steps / _max_sm_clock_hz()
    out = {"flows": F, "links": L, "memberships": nnz,
           "padded": [F_p, L_p, width], "rounds": rounds,
           "max_abs_err": float(np.max(np.abs(card_rates - cpu_rates))),
           "max_rel_err_cpu": rel_cpu, "max_rel_err_oracle": rel_ref,
           "max_rel_err_card_plain": rel_plain,
           "ms": kernel_ms, "host_ms": call_ms, "split_ms": split,
           "plain_ms": plain_ms, "cpu_plain_ms": cpu_ms,
           "scalar_ms": scalar_ms, "bytes": solve_bytes,
           "bytes_ms": bytes_ms, "chain_ms": chain_ms,
           "bound_ms": max(bytes_ms, chain_ms),
           "bound_by": "operations" if chain_ms > bytes_ms else "bytes",
           "library_ms": None, "control_link": int(halve)}
    say(f"H snapshot {label}: {F} flows over {L} links (padded "
        f"{out['padded']}), {rounds} rounds; card vs oracle max rel "
        f"{rel_ref:.2e} (tol {MAXMIN_REF_RTOL} + {MAXMIN_REF_ATOL:g}), vs "
        f"the plain version on the CPU {rel_cpu:.2e} and on the card "
        f"{rel_plain:.2e} (tol {MAXMIN_CPU_RTOL}); controls (link {halve}, "
        f"{int(mem[:, halve].sum())} flows, halved) fail both; kernel "
        f"{kernel_ms:.4f} ms (a CUDA graph of launches, CUDA events), "
        f"plain version on the card {plain_ms:.4f} ms, whole call "
        f"{call_ms:.4f} ms (host clock; packing {split['pack']:.4f}, copy "
        f"{split['copy']:.4f} and launch {split['launch']:.4f} by CUDA "
        f"events, read {split['read']:.4f}), "
        f"plain version on the CPU {cpu_ms:.4f} ms, scalar solver "
        f"{scalar_ms:.4f} ms; bound {out['bound_ms']:.6f} ms by "
        f"{out['bound_by']} (bytes {bytes_ms:.6f} ms for {solve_bytes} B; "
        f"chain {chain_ms:.6f} ms: {chain_steps} steps)", card)
    return out


def _call_split(problem, iters: int) -> dict:
    """``maxmin_rates_sparse``'s call on the card in four parts, ms each:
    host packing (``Staging`` and ``pad_problem``, host clock), the copy
    to the card and the launch (CUDA events: the launch's includes the
    wrapper's host work, while the card waits), and the read of the
    result (host clock around the copy back, after the launch ended)."""
    import torch

    from repro_torch.kernels import maxmin
    link_caps, flow_links, flow_caps = problem
    F_p = maxmin._next_pow2(len(flow_links))
    L_p = maxmin._next_pow2(len(link_caps) + 1)
    width = maxmin._next_pow2(max(len(r) for r in flow_links), floor=4)
    dev = torch.device("cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    parts = dict.fromkeys(("pack", "copy", "launch", "read"), 0.0)
    for _ in range(iters):
        t0 = time.perf_counter()
        staging = maxmin.Staging(1, F_p, L_p, width, dev)
        maxmin.pad_problem(link_caps, flow_links, flow_caps, F_p, L_p,
                           width, out=staging.problem(0))
        t1 = time.perf_counter()
        ev[0].record()
        buf = staging.upload()
        ev[1].record()
        out = maxmin.WATERFILL(*staging.views(buf))
        ev[2].record()
        ev[2].synchronize()
        t2 = time.perf_counter()
        out.cpu()
        t3 = time.perf_counter()
        parts["pack"] += 1e3 * (t1 - t0)
        parts["copy"] += ev[0].elapsed_time(ev[1])
        parts["launch"] += ev[1].elapsed_time(ev[2])
        parts["read"] += 1e3 * (t3 - t2)
    return {k: v / iters for k, v in parts.items()}


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
    _reset_counts()
    counts.reset()                           # the storm's path starts here
    t0 = time.perf_counter()
    rep = core.run_scenario(_storm_spec(core, "vector", "cuda"))
    wall = time.perf_counter() - t0
    launches = maxmin.WATERFILL.launches
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
    if launches != solves:
        raise AssertionError(f"H: {launches} maxmin_waterfill launches for "
                             f"{solves} solves on the card")
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
    say(f"H solver: {solves} solves on cuda, {launches} launches of "
        f"maxmin_waterfill; flows per solve median "
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
    return {"launches": launches, "solves": solves, "wall_s": wall,
            "solve_host_s": run.host_seconds,
            "flows_median": statistics.median(sizes),
            "flows_max": max(sizes), "rounds": run.rounds,
            "syncs": run.syncs, "h2d": run.h2d, "d2h": run.d2h,
            "scalar_wall_s": scalar_wall, "snapshots": snaps}


# ---------------------------------------------------------------------------
# The sweeps: an eviction sweep at a day's traffic (I)
# ---------------------------------------------------------------------------
SWEEP_PODS, SWEEP_HOSTS = 4, 4           # FederationSpec.fleet(4, 4)
SWEEP_REQUESTS = 4000
SWEEP_AXES = {"federation.cache_capacity": [2e9, 8e9, 32e9, 32e12],
              "federation.eviction_policy": ["lru", "fifo"],
              "federation.admission_max_fraction": [1.0, 0.25],
              "outage_rate": [0.0, 0.5]}
# the reference's totals over sweep I's 32 cells (JAX, on a CPU)
SWEEP_WANT = {"cache_hits": 1262846, "cache_misses": 2518530,
              "origin_egress_bytes": 62291090882770,
              "evictions": 1602456, "bytes_evicted": 39521117792682,
              "admission_rejects": 521762, "bytes_moved": 93677581311872}
SWEEP_WANT_FINISH_S = 42189.425549687745  # sum of storm_finish_seconds
# the reference's EVICTION_PARITY_KEYS (benchmarks/bench_sweep.py:53)
EVICTION_PARITY_KEYS = ("bytes_moved", "cache_hits", "cache_misses",
                        "origin_egress_bytes", "evictions", "bytes_evicted",
                        "admission_rejects")
SCANS = {"stack_distance": "stack_distances", "cache_sim": "cache_sim",
         "fifo_replay": "fifo_replay"}      # kernel → its ops function
# bytes a reference moves at least (inputs read once, outputs written
# once): prev, size and distance; key, admit, reset and hit; key, size,
# admit, reset and hit
SCAN_REF_BYTES = {"stack_distance": 24, "cache_sim": 7, "fifo_replay": 15}


def _sweep_spec(core, device, n_requests=SWEEP_REQUESTS, axes=SWEEP_AXES):
    base = core.ScenarioSpec(
        name="eviction-sweep", engine="analytic",
        federation=core.FederationSpec.fleet(num_pods=SWEEP_PODS,
                                             hosts_per_pod=SWEEP_HOSTS),
        workload=core.WorkloadSpec(kind="zipf", n_requests=n_requests,
                                   working_set=1000, duration=86400.0),
        device=device)
    return core.SweepSpec(name="eviction-sweep", base=base, axes=axes)


class _SweepRecorder:
    """Wraps the three scans' ``ops`` functions (unless ``scans`` is
    false), ``ops.mixture_fit`` (if ``fits``) and the sweep's batched
    solver for one run: keeps every call's inputs and outputs (references,
    no copies) and CUDA events around each scan call."""

    def __init__(self, scans: bool = True, fits: bool = False) -> None:
        self.calls = {name: [] for name in SCANS}
        self.pricing = []
        self.fits = []
        self.scans = scans
        self.record_fits = fits

    def __enter__(self):
        import torch

        import repro_torch.core.api as api
        from repro_torch.kernels import ops
        self._saved = [(ops, fn, getattr(ops, fn)) for fn in SCANS.values()
                       if self.scans]
        self._saved.append((api, "maxmin_rates_batch",
                            api.maxmin_rates_batch))
        for name, fn in SCANS.items() if self.scans else ():
            def wrapped(*args, _orig=getattr(ops, fn), _name=name):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _orig(*args)
                end.record()
                self.calls[_name].append((args, out, start, end))
                return out
            setattr(ops, fn, wrapped)

        if self.record_fits:
            self._saved.append((ops, "mixture_fit", ops.mixture_fit))

            def fit(*args, _orig=ops.mixture_fit):
                out = _orig(*args)
                self.fits.append((args, out))
                return out
            ops.mixture_fit = fit

        def pricing(problems, stats=None, device=None,
                    _orig=api.maxmin_rates_batch):
            rates = _orig(problems, stats=stats, device=device)
            self.pricing.append((problems, rates))
            return rates
        api.maxmin_rates_batch = pricing
        return self

    def __exit__(self, *exc) -> None:
        for module, fn, orig in self._saved:
            setattr(module, fn, orig)

    def event_ms(self, name: str) -> float:
        return sum(s.elapsed_time(e) for _, _, s, e in self.calls[name])


def _scan_plain(name: str, args):
    from repro_torch.kernels import ref
    plain = {"stack_distance": ref.stack_distances_ref,
             "cache_sim": ref.cache_sim_ref,
             "fifo_replay": ref.fifo_replay_ref}[name]
    return plain(*args[:-1])          # the plain versions take no lengths


def _same_floats(got, want):
    """Exact equality of two float tensors where NaN equals NaN (a FIFO
    replay's bytes evicted after an oversize admit), and the largest
    absolute difference elsewhere."""
    import torch
    nan = torch.isnan(want)
    same = torch.equal(torch.isnan(got), nan) and \
        torch.equal(got[~nan], want[~nan])
    diff = (got[~nan] - want[~nan]).abs()
    return same, float(diff.max()) if diff.numel() else 0.0


def _scan_equal(name: str, got, want, lengths) -> dict:
    """Exact comparison of a scan's outputs within each problem's length:
    distances (inf included), or hits, evictions and bytes evicted (NaN
    included)."""
    import torch
    if name == "stack_distance":
        finite = torch.isfinite(want)
        same = torch.equal(torch.isinf(got), torch.isinf(want)) and \
            torch.equal(got[finite], want[finite])
        err = float((got[finite] - want[finite]).abs().max()) \
            if finite.any() else 0.0
        return {"equal": same, "max_abs_err": err}
    hits, ev, evb = got
    w_hits, w_ev, w_evb = want
    rows = all(torch.equal(hits[b, :n], w_hits[b, :n])
               for b, n in enumerate(lengths.tolist()))
    same_evb, evb_err = _same_floats(evb, w_evb)
    err = max(float((ev - w_ev).abs().max()), evb_err)
    return {"equal": rows and torch.equal(ev, w_ev) and same_evb,
            "max_abs_err": err}


def _exact_fill_capacities(keys, sizes, admit, reset):
    """Capacities at which an insert exactly fills the cache before any
    eviction or reset (every inserted key is still resident): at each, the
    m-th insert fits (usage + size == capacity), and one byte less evicts
    there; m = 64, 65, ..."""
    seen, total, out = set(), 0.0, []
    for t in range(len(keys)):
        if reset[t]:
            break
        if keys[t] in seen or not admit[t]:
            continue
        seen.add(keys[t])
        total += sizes[t]
        if len(seen) >= 64:
            out.append(total)
    return out


CONTROL_REFS = 2048        # the control problem: a prefix of a recorded one


def _largest(rec, name: str) -> int:
    """The index of a scan's first call at its largest bucket of the run."""
    sizes = [args[0].numel() for args, _, _, _ in rec.calls[name]]
    return sizes.index(max(sizes))


def _distance_control(rec, card: str) -> dict:
    """The control of sd_distances' exactness check, on the longest
    problem of its largest bucket, whole, at the bucket's width: one byte
    added to the size of a reference j whose key is not referenced again
    before a later reuse i with prev p < j, where j and i first share a
    run at the highest merge level the problem offers (above the tile, so
    the tiles' prefix sums and the levels over the row carry the byte).
    The plain version's distance at i moves by one byte.  The kernel on
    that input must equal the plain version on it, and fail the same
    check against the plain version on the original input."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import stack_distance as sd
    args = rec.calls["stack_distance"][_largest(rec, "stack_distance")][0]
    k = int(torch.argmax(args[-1]))
    n, width = int(args[-1][k]), args[0].shape[1]
    prev = args[0][k, :n].cpu().numpy()
    pos = np.arange(n)
    nxt = np.full(n, n)                   # each position's first reuse
    reuse = (prev >= 0) & (prev < pos)
    np.minimum.at(nxt, prev[reuse], pos[reuse])
    found = None
    for level in range(width.bit_length() - 2,
                       sd.DIST_TILE.bit_length() - 2, -1):
        for b in range(1 << level, n, 2 << level):   # a run's boundary
            for j in range(b - 1, max(b - 257, -1), -1):
                seg = prev[b:nxt[j]]
                hit = np.flatnonzero((seg >= 0) & (seg < j))
                if hit.size:
                    found = (j, b + int(hit[0]))
                    break
            if found:
                break
        if found:
            break
    if found is None:
        raise AssertionError("I control stack_distance: no reuse whose gap "
                             "crosses a tile boundary")
    j, i = found
    level = (i ^ j).bit_length() - 1      # where j and i share a run
    two_prev = args[0][k:k + 1].repeat(2, 1)
    two_sizes = args[1][k:k + 1].repeat(2, 1)
    two_sizes[1, j] += 1.0
    lengths = torch.full((1,), n, dtype=torch.int32, device=args[0].device)
    want = _scan_plain("stack_distance", (two_prev, two_sizes, None))
    got = ops.stack_distances(two_prev[1:], two_sizes[1:], lengths)
    exact = _scan_equal("stack_distance", got, want[1:], lengths)
    control = _scan_equal("stack_distance", got, want[:1], lengths)
    moved = float(want[1, i] - want[0, i])
    if not exact["equal"] or control["equal"] or moved != 1.0:
        raise AssertionError(f"I control stack_distance: the kernel on the "
                             f"input with one byte more equals the plain "
                             f"version on it: {exact['equal']}; on the "
                             f"original: {control['equal']}; the distance "
                             f"at {i} moved by {moved}")
    say(f"I control stack_distance: problem {k} of the bucket "
        f"{tuple(args[0].shape)} ({n} references) with one byte added to "
        f"reference {j}, inside the gap of reference {i} (prev "
        f"{int(prev[i])}, distance {float(want[0, i]):.0f} B; the two first "
        f"share a run of {2 << level} at merge level {level}, above the "
        f"tile of {sd.DIST_TILE}): the kernel equals the plain version on "
        f"that input, and fails the same check against the original (off "
        f"by up to {control['max_abs_err']:.0f} B), as it must", card)
    return {"problem": k, "refs": n, "width": width, "reference": i,
            "bumped": j, "level": level,
            "distance_plain": float(want[0, i]), "moved_by": moved,
            "control_max_abs_err": control["max_abs_err"]}


def _controls(rec, card: str) -> dict:
    """The control of the exactness checks, for each replay: the first
    recorded problem cut to its first 2,048 references, at the smallest
    exact-fill capacity C (see above) where one byte decides the counters
    (the kernel's answers at C and C - 1 differ).  The kernel at C must
    equal the plain version at C, and the kernel at C - 1 (the control)
    must fail that same check."""
    import torch

    from repro_torch.kernels import ops
    per_ref = {"fifo_replay": 4, "cache_sim": 3}   # leading (B, Np) args
    out = {"stack_distance": _distance_control(rec, card)}
    for name in ("fifo_replay", "cache_sim"):
        args = rec.calls[name][0][0]
        n = min(int(args[-1][0]), CONTROL_REFS)
        base = [t[:1, :n].clone() if i < per_ref[name] else t[:1].clone()
                for i, t in enumerate(args[:-1])]
        lengths = torch.full((1,), n, dtype=torch.int32,
                             device=args[0].device)
        cap_at = 5 if name == "fifo_replay" else 4
        keys = base[0][0].cpu().numpy()
        if name == "fifo_replay":
            sizes = base[1][0].cpu().numpy()
            admit, reset = base[2][0].cpu().numpy(), base[3][0].cpu().numpy()
        else:
            sizes = base[3][0].cpu().numpy()[keys]
            admit, reset = base[1][0].cpu().numpy(), base[2][0].cpu().numpy()

        def run(capacity, plain=False):
            a = list(base)
            a[cap_at] = torch.full((1,), capacity, dtype=torch.float64,
                                   device=lengths.device)
            if plain:
                return _scan_plain(name, a + [None])
            return getattr(ops, SCANS[name])(*a, lengths)
        cap = next((c for c in _exact_fill_capacities(keys, sizes, admit,
                                                      reset)
                    if not _scan_equal(name, run(c), run(c - 1),
                                       lengths)["equal"]), None)
        if cap is None:
            raise AssertionError(f"I control {name}: no exact-fill "
                                 f"capacity decides the counters")
        want = run(cap, plain=True)
        exact = _scan_equal(name, run(cap), want, lengths)
        control = _scan_equal(name, run(cap - 1), want, lengths)
        if not exact["equal"] or control["equal"]:
            raise AssertionError(f"I control {name}: the kernel equals the "
                                 f"plain version at {cap:.0f} B: "
                                 f"{exact['equal']}; at one byte less: "
                                 f"{control['equal']}")
        out[name] = {"capacity": cap, "refs": n,
                     "evictions_plain": int(want[1][0]),
                     "control_max_abs_err": control["max_abs_err"]}
        say(f"I control {name}: the first problem's first {n} references "
            f"at {cap:.0f} B, where an insert exactly fills the cache: the "
            f"kernel equals the plain version ({out[name]['evictions_plain']}"
            f" evictions); at {cap - 1:.0f} B it fails the same check (its "
            f"counters off by up to {control['max_abs_err']:.0f}, or its "
            f"hits differ), as it must", card)
    return out


# the FIFO replay after an admitted insert larger than the capacity
# (keys, sizes, capacity): the frontier moves to +inf
OVERSIZE = ([0, 1, 2, 0, 3], [4.0, 4.0, 20.0, 4.0, 4.0], 10.0)
# name: (references of OVERSIZE, the reset's step or None, the row's
# width, the reference's bytes evicted)
OVERSIZE_CASES = {"no later reset": (5, None, 5, "nan"),
                  "a reset on the next step": (5, 3, 5, "inf"),
                  "the same, padded": (5, 3, 256, "inf"),
                  "oversize last": (3, None, 3, "inf"),
                  "oversize last, padded": (3, None, 256, "nan")}


def _fifo_oversize(rec, card: str) -> dict:
    """sd_fifo_replay after an admitted oversize insert against its plain
    version, NaN included: the hand-made cases above (one launch each),
    and the first recorded problem's first 2,048 references with every
    reference admitted at one byte under its largest chunk."""
    import torch

    from repro_torch.kernels import ops
    dev = rec.calls["fifo_replay"][0][0][0].device
    out = {}
    for label, (n, reset_at, width, want) in OVERSIZE_CASES.items():
        keys, sizes, cap = OVERSIZE
        reset = [False] * width
        if reset_at is not None:
            reset[reset_at] = True
        args = [torch.tensor(keys[:n] + [0] * (width - n), dtype=torch.int32,
                             device=dev),
                torch.tensor(sizes[:n] + [0.0] * (width - n),
                             dtype=torch.float64, device=dev),
                torch.tensor([True] * n + [False] * (width - n),
                             device=dev),
                torch.tensor(reset, device=dev)]
        args = [a[None] for a in args] + [
            torch.zeros(1, 4, dtype=torch.float64, device=dev),
            torch.tensor([cap], dtype=torch.float64, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev)]
        got = ops.fifo_replay(*args)
        res = _scan_equal("fifo_replay", got, _scan_plain("fifo_replay",
                                                          args), args[-1])
        evb = float(got[2][0])
        if not res["equal"] or str(evb) != want:
            raise AssertionError(f"I fifo_replay oversize, {label}: bytes "
                                 f"evicted {evb} (the reference's {want}), "
                                 f"equal to the plain version: "
                                 f"{res['equal']}")
        out[label] = str(evb)
    args = rec.calls["fifo_replay"][0][0]
    n = min(int(args[-1][0]), CONTROL_REFS)
    keys, sizes, _, reset, kcum0, _, _ = (t[:1, :n].clone() if t.dim() == 2
                                          and i < 4 else t[:1].clone()
                                          for i, t in enumerate(args))
    admit = torch.ones_like(reset)
    cap = sizes.max().reshape(1) - 1.0
    lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    a = [keys, sizes, admit, reset, kcum0, cap, lengths]
    got = ops.fifo_replay(*a)
    res = _scan_equal("fifo_replay", got, _scan_plain("fifo_replay", a),
                      lengths)
    if not res["equal"] or torch.isfinite(got[2]).any():
        raise AssertionError(f"I fifo_replay oversize, recorded problem: "
                             f"bytes evicted {float(got[2][0])}, equal to "
                             f"the plain version: {res['equal']}")
    out["recorded problem"] = str(float(got[2][0]))
    say(f"I fifo_replay after an admitted oversize insert: {out} bytes "
        f"evicted, each equal to the plain version's (NaN to NaN), hits "
        f"and evictions too; the recorded case is the first problem's "
        f"first {n} references, all admitted, at {float(cap[0]):.0f} B, "
        f"one byte under its largest chunk", card)
    return out


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _scan_numbers(name: str, rec, plain_s: list, clock_hz: float) -> dict:
    """A scan's numbers at its largest bucket of the run: the kernel alone
    (CUDA events, resident inputs), the plain version (host clock around
    one synchronised call, on the card), and the bound: bytes (each
    reference's inputs read once and outputs written once, the key state
    once) at 3.35 TB/s, or for the replays the chain of the longest
    problem's dependent steps at one clock each, whichever is larger."""
    from repro_torch.kernels import ops
    main = _largest(rec, name)
    args = rec.calls[name][main][0]
    fn = getattr(ops, SCANS[name])
    iters = 20 if name == "stack_distance" else 3
    ms = time_ms(lambda: fn(*args), iters)
    lengths = args[-1].tolist()
    refs = sum(lengths)
    nbytes = refs * SCAN_REF_BYTES[name]
    if name != "stack_distance":
        nbytes += args[3 if name == "cache_sim" else 4].numel() * 8
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    chain_ms = 0.0 if name == "stack_distance" else \
        1e3 * max(lengths) / clock_hz
    return {"bucket": list(args[0].shape) + (
                [args[3 if name == "cache_sim" else 4].shape[1]]
                if name != "stack_distance" else []),
            "problems": sum(1 for n in lengths if n), "refs": refs,
            "ms": ms, "plain_ms": 1e3 * plain_s[main], "bytes": nbytes,
            "bytes_ms": bytes_ms, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "operations" if chain_ms > bytes_ms else "bytes",
            "library_ms": None,
            "us_per_step": None if name == "stack_distance" else
            1e3 * ms / max(lengths)}


def _rate_errors(got, want):
    """The largest relative and absolute differences of two lists of rate
    arrays."""
    import numpy as np
    pairs = [(np.asarray(c), np.asarray(w)) for c, w in zip(got, want)
             if len(w)]
    rel = max(float(np.max(np.abs(c - w) / np.maximum(np.abs(w), 1e-30)))
              for c, w in pairs)
    return rel, max(float(np.max(np.abs(c - w))) for c, w in pairs)


def _solver_numbers(label: str, pricing, card: str, clock_hz: float,
                    design: Optional[str] = None) -> dict:
    """The batched solver at a sweep's pricing (``pricing``: the recorded
    calls, problems and the card's rates): every rate against the plain
    version on the CPU (1e-6 relative), with a control (the most-shared
    saturated link of the chosen bucket's largest problem halved) that
    must fail it.  At the largest bucket (of the design ``design``, when
    given) the kernel alone on resident inputs (CUDA events), the plain
    version (the torch-ops loop) on the card and on the CPU (host clock),
    and the bound: the bucket's bytes, or the rounds' chain of its
    slowest problem (four barriers and log2(threads) shuffle steps a
    round, one clock each), whichever is larger."""
    import numpy as np
    import torch

    from repro_torch.kernels import batched_maxmin, maxmin
    problems = [p for probs, _ in pricing for p in probs]
    card_rates = [r for _, rates in pricing for r in rates]
    cpu_rates = batched_maxmin.maxmin_rates_batch(problems, device="cpu")
    rel, err = _rate_errors(card_rates, cpu_rates)
    if rel > MAXMIN_CPU_RTOL:
        raise AssertionError(f"{label} solver: card vs CPU ops, max rel "
                             f"{rel}")
    buckets = {}
    for i, p in enumerate(problems):
        buckets.setdefault(batched_maxmin._bucket_of(p), []).append(i)
    if design is not None:
        buckets = {b: idx for b, idx in buckets.items()
                   if maxmin.WATERFILL.design(*b) == design}
        if not buckets:
            raise AssertionError(f"{label} solver: no bucket of the design "
                                 f"{design} in the sweep's pricing")
    (Fp, Lp, width), idxs = max(buckets.items(),
                                key=lambda kv: len(kv[1]) * kv[0][0])
    group = [problems[i] for i in idxs]
    big = max(idxs, key=lambda i: len(problems[i][1]))
    link_caps, flow_links, flow_caps = problems[big]
    load = np.zeros(len(link_caps))
    share = np.zeros(len(link_caps), np.int64)
    for f, row in enumerate(flow_links):
        np.add.at(load, row, cpu_rates[big][f])
        np.add.at(share, row, 1)
    saturated = np.flatnonzero(load >= 0.999 * np.asarray(link_caps))
    if not saturated.size:
        raise AssertionError(f"{label} solver: no saturated link to halve "
                             f"for the control")
    halve = int(saturated[np.argmax(share[saturated])])
    halved = list(link_caps)
    halved[halve] /= 2
    ctl_rel, _ = _rate_errors([card_rates[big]],
                              batched_maxmin.maxmin_rates_batch(
                                  [(halved, flow_links, flow_caps)],
                                  device="cpu"))
    if ctl_rel <= MAXMIN_CPU_RTOL:
        raise AssertionError(f"{label} solver: the control (link {halve} "
                             f"halved) passed the check")
    B = maxmin._next_pow2(len(group), floor=1)
    staging = maxmin.Staging(B, Fp, Lp, width, torch.device("cuda"))
    staging.caps.fill(np.inf)
    staging.ids.fill(Lp - 1)
    staging.fcaps.fill(0.0)
    for bi, p in enumerate(group):
        maxmin.pad_problem(*p, Fp=Fp, Lp=Lp, width=width,
                           out=staging.problem(bi))
    args = staging.views(staging.upload())
    ms = graph_ms(lambda: maxmin.WATERFILL(*args))
    rounds = maxmin.WATERFILL(*args)[:, Fp].cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maxmin.plain_waterfill(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    cpu_args = [a.cpu() for a in args]
    t0 = time.perf_counter()
    maxmin.plain_waterfill(*cpu_args)
    cpu_plain_ms = 1e3 * (time.perf_counter() - t0)
    nnz = sum(len(r) for p in group for r in p[1])
    flows = sum(len(p[1]) for p in group)
    links = sum(len(p[0]) for p in group)
    nbytes = 4 * nnz + 8 * flows + 4 * links
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    chain_steps = int(rounds.max()) * (
        3 + maxmin.WATERFILL.threads(Fp).bit_length())
    chain_ms = 1e3 * chain_steps / clock_hz
    return {"max_abs_err": err, "max_rel_err_cpu": rel,
            "problems_checked": len(problems),
            "control": {"problem_flows": len(flow_links), "link": halve,
                        "link_flows": int(share[halve]),
                        "max_rel_err_cpu": ctl_rel},
            "design": maxmin.WATERFILL.design(Fp, Lp, width), "ms": ms,
            "plain_ms": plain_ms, "cpu_plain_ms": cpu_plain_ms,
            "bytes_ms": bytes_ms, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "operations" if chain_ms > bytes_ms else "bytes",
            "library_ms": None, "bytes": nbytes,
            "bucket": [B, Fp, Lp, width], "problems": len(group),
            "flows": flows, "max_rounds": int(rounds.max())}


def _say_solver(label: str, sm: dict, card: str) -> None:
    ctl = sm["control"]
    say(f"{label} batched_maxmin: the card's rates of "
        f"{sm['problems_checked']} problems vs the plain version on the "
        f"CPU max rel {sm['max_rel_err_cpu']:.2e} (tol {MAXMIN_CPU_RTOL}); "
        f"control (link {ctl['link']} of a problem of "
        f"{ctl['problem_flows']} flows, {ctl['link_flows']} of them on it, "
        f"halved) fails: {ctl['max_rel_err_cpu']:.2e}; bucket "
        f"{sm['bucket']} (design {sm['design']}, {sm['problems']} "
        f"problems, {sm['flows']} flows, up to {sm['max_rounds']} rounds): "
        f"kernel {sm['ms']:.4f} ms (a CUDA graph of launches, CUDA "
        f"events), plain version on the card {sm['plain_ms']:.1f} ms and "
        f"on the CPU {sm['cpu_plain_ms']:.1f} ms (host clock); bound "
        f"{sm['bound_ms']:.6f} ms by {sm['bound_by']} (bytes "
        f"{sm['bytes_ms']:.6f} ms for {sm['bytes']} B; chain "
        f"{sm['chain_ms']:.6f} ms)", card)


def phase_sweep(card: str) -> dict:
    """I: an eviction sweep at a day's traffic on the card: 32 cells
    (capacity × policy × admission × outage) over a 4-pod fleet, every
    cell batched, hit/miss resolved by the three scan kernels and the
    storms priced by the batched solver.  Returns the kernels' numbers."""
    import torch

    import repro_torch.core as core
    from repro_torch.kernels import maxmin
    from repro_torch.kernels import stack_distance as sd

    core.run_sweep(_sweep_spec(core, "cuda", n_requests=200))   # warm
    kernels = {"stack_distance": sd.DISTANCES, "cache_sim": sd.CACHE_SIM,
               "fifo_replay": sd.FIFO_REPLAY}
    _reset_counts()
    maxmin.COUNTS.reset()                 # the sweep's path starts here
    with _SweepRecorder() as rec:
        t0 = time.perf_counter()
        rep = core.run_sweep(_sweep_spec(core, None))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    fifo_designs = dict(sd.FIFO_REPLAY.launches_by_design)
    sim_designs = dict(sd.CACHE_SIM.launches_by_design)
    solver_launches = maxmin.WATERFILL.launches
    solver = dataclasses.replace(maxmin.COUNTS)   # ... and ends here
    n_cells = len(rep.cells)
    if (rep.batched_cells, rep.serial_cells) != (n_cells, 0) or \
            n_cells != 32:
        raise AssertionError(f"I: {rep.batched_cells} batched and "
                             f"{rep.serial_cells} serial cells of {n_cells}")
    if min(launches.values()) < 1 or solver.batched_calls < 1:
        raise AssertionError(f"I: launches {launches}, batched solves "
                             f"{solver.batched_calls}: every scan and the "
                             f"solver must run on the sweep's path")
    if solver_launches != solver.batched_calls:
        raise AssertionError(f"I: {solver_launches} maxmin_waterfill "
                             f"launches for {solver.batched_calls} batched "
                             f"solves")
    for name, designs in (("fifo_replay", fifo_designs),
                          ("cache_sim", sim_designs)):
        if designs["smem"] != launches[name]:
            raise AssertionError(f"I: {name} launches by design {designs}: "
                                 f"every one must keep its key state in "
                                 f"shared memory")
    small = [c for c in rep.cells
             if c.params["federation.cache_capacity"] == 2e9]
    if not all(c.summary["evictions"] > 0 for c in small):
        raise AssertionError("I: a cell at 2e9 evicted nothing")
    got = {k: sum(c.summary[k] for c in rep.cells) for k in SWEEP_WANT}
    if got != SWEEP_WANT:
        raise AssertionError(f"I: totals {got}, the reference's "
                             f"{SWEEP_WANT}")
    finish = sum(c.pricing["storm_finish_seconds"] for c in rep.cells)
    if abs(finish - SWEEP_WANT_FINISH_S) > SOLVER_RTOL * SWEEP_WANT_FINISH_S:
        raise AssertionError(f"I: storm finish seconds {finish}, the "
                             f"reference's {SWEEP_WANT_FINISH_S}")
    scan_ms = {name: rec.event_ms(name) for name in SCANS}
    say(f"I (eviction sweep, fleet {SWEEP_PODS} pods x {SWEEP_HOSTS} hosts, "
        f"zipf {SWEEP_REQUESTS} requests over a day, {n_cells} cells: "
        f"capacity x policy x admission x outage, device cuda): "
        f"{wall:.2f} s wall (host clock); {rep.batched_cells} batched, "
        f"{rep.serial_cells} serial; longest stream "
        f"{rep.solver.get('max_stream_refs')} references; totals equal the "
        f"reference's {SWEEP_WANT}; storm finish seconds {finish:.6f} "
        f"(reference {SWEEP_WANT_FINISH_S:.6f}, within {SOLVER_RTOL})", card)
    say(f"I kernels' share of the wall time: scans {sum(scan_ms.values()):.1f}"
        f" ms (CUDA events around each call) = "
        f"{100 * sum(scan_ms.values()) / 1e3 / wall:.2f}%; batched solver "
        f"{1e3 * solver.host_seconds:.1f} ms (host clock) = "
        f"{100 * solver.host_seconds / wall:.2f}%", card)
    say(f"I solver: {solver.batched_calls} batched solve(s) on cuda, "
        f"{solver_launches} launch(es) of maxmin_waterfill, over "
        f"{solver.batched_problems} problems, buckets "
        f"{rep.solver.get('buckets')}; {solver.rounds} rounds, "
        f"{solver.syncs} host reads, {solver.h2d} copies host->device, "
        f"{solver.d2h} device->host", card)
    # every problem the sweep handed a scan, solved again by its plain
    # version on the card, where its inputs already lie, exactly equal
    plain_s = {name: [] for name in SCANS}
    checked = {}
    for name in SCANS:
        worst = 0.0
        problems = 0
        for args, out, _, _ in rec.calls[name]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = _scan_plain(name, args)
            torch.cuda.synchronize()
            plain_s[name].append(time.perf_counter() - t0)
            res = _scan_equal(name, out, want, args[-1])
            if not res["equal"]:
                raise AssertionError(f"I {name}: the kernel differs from "
                                     f"its plain version on bucket "
                                     f"{tuple(args[0].shape)}")
            worst = max(worst, res["max_abs_err"])
            problems += int((args[-1] > 0).sum())
        checked[name] = {"problems": problems, "max_abs_err": worst}
    controls = _controls(rec, card)
    oversize = _fifo_oversize(rec, card)
    clock_hz = _max_sm_clock_hz()
    out = {}
    for name in SCANS:
        nums = _scan_numbers(name, rec, plain_s[name], clock_hz)
        nums.update(launches=launches[name],
                    max_abs_err=checked[name]["max_abs_err"],
                    err_over_tol=0.0, problems_checked=checked[name][
                        "problems"],
                    buckets=[list(a[0].shape) + (
                        [] if name == "stack_distance" else
                        [a[3 if name == "cache_sim" else 4].shape[1]])
                        for a, _, _, _ in rec.calls[name]],
                    event_ms_per_launch=scan_ms[name] / max(launches[name],
                                                            1),
                    control=controls.get(name))
        out[name] = nums
        say(f"I {name}: {launches[name]} launches on the sweep's path, "
            f"buckets (B, Np[, Kp]) {nums['buckets']}; "
            f"{nums['event_ms_per_launch']:.3f} ms per launch in the sweep "
            f"(CUDA events); at its largest bucket {nums['bucket']} "
            f"({nums['problems']} problems, {nums['refs']} references) "
            f"{nums['ms']:.4f} ms alone (CUDA events), plain version on the "
            f"card {nums['plain_ms']:.1f} ms (host clock); bound "
            f"{nums['bound_ms']:.6f} ms by {nums['bound_by']} (bytes "
            f"{nums['bytes_ms']:.6f} ms for {nums['bytes']} B at 3.35 TB/s; "
            f"chain {nums['chain_ms']:.6f} ms: the longest problem's steps "
            f"at one clock of {clock_hz / 1e6:.0f} MHz); all "
            f"{checked[name]['problems']} problems exactly equal to the "
            f"plain version", card)
    say(f"I launches by design: fifo_replay {fifo_designs}, cache_sim "
        f"{sim_designs}; a dependent step at each one's largest bucket: "
        f"fifo_replay {out['fifo_replay']['us_per_step']:.4f} us, "
        f"cache_sim {out['cache_sim']['us_per_step']:.4f} us", card)
    out["fifo_replay"]["launches_by_design"] = fifo_designs
    out["fifo_replay"]["oversize"] = oversize
    out["cache_sim"]["launches_by_design"] = sim_designs
    out["batched_maxmin"] = _solver_numbers("I", rec.pricing, card,
                                            clock_hz)
    out["batched_maxmin"].update(
        launches=solver_launches, rounds=solver.rounds,
        syncs=solver.syncs, host_s=solver.host_seconds)
    _say_solver("I", out["batched_maxmin"], card)
    say(f"I batched_maxmin: the whole batched call "
        f"{1e3 * solver.host_seconds:.1f} ms (host clock)", card)
    # the batched path against the serial one, at 2e9 and admission 0.25
    serial_axes = {"federation.cache_capacity": [2e9],
                   "federation.eviction_policy": ["lru", "fifo"],
                   "federation.admission_max_fraction": [0.25],
                   "outage_rate": [0.0, 0.5]}
    t0 = time.perf_counter()
    serial = core.run_sweep(_sweep_spec(core, None, axes=serial_axes),
                            batched=False, price_contention=False)
    serial_wall = time.perf_counter() - t0
    for cell in serial.cells:
        batched = rep.cell(**cell.params)
        for k in EVICTION_PARITY_KEYS:
            if cell.summary[k] != batched.summary[k]:
                raise AssertionError(f"I serial vs batched {cell.params} "
                                     f"{k}: {cell.summary[k]} != "
                                     f"{batched.summary[k]}")
    say(f"I serial executor: {len(serial.cells)} cells (lru and fifo, "
        f"outage 0 and 0.5, 2e9, admission 0.25) in {serial_wall:.2f} s "
        f"(host clock), {', '.join(EVICTION_PARITY_KEYS)} equal to the "
        f"batched cells'", card)
    out["wall_s"] = wall
    out["serial_wall_s"] = serial_wall
    out["scan_event_ms"] = scan_ms
    return out


# ---------------------------------------------------------------------------
# The planner (J): fit sweeps, plans and their exact-replay verification
# ---------------------------------------------------------------------------
PLAN_TARGET = 0.5
OSDF_REGIONS = ("us-east", "us-central", "us-west", "eu")
OSDF_EDGES, OSDF_REQUESTS = 6, 8000
PLAN_TILE = 9                # J2's models tiled to 252 caches (timing only)
PLAN_RTOL = 1e-9             # a plan, card vs plain version and reference
# The budget plan's control: a budget moved by this share of the span it
# is taken from (the egress at max_capacity to the first plan's)
BUDGET_SHIFT = 1e-3
# A 400-step mixture fit can wander along a flat valley of its loss
# (tests/test_torch_cache_model.py, MIX_TOL).
MIX_TOL = {"param": 1e-4, "cdf": 1e-6, "loss": 1e-6}
MIX_STEPS, MIX_LR = 400, 0.08
SAVINGS_FLOOR = 0.15         # the reference CI's gate on bench_plan
FP64_FLOPS = 34e12           # H100 SXM, FP64 outside the tensor cores
# The reference's numbers (JAX on a CPU: `tests/tools/reference_want.py`);
# capacities in the order of the sorted group names.
J1_WANT = {
    "capacities": [6391878914.065353, 64021357.360792376],
    "uniform_capacity": 5848887276.084394,
    "savings_vs_uniform": 0.44810867719884295,
    "predicted_hit_rate": 0.5020000000000003,
    "predicted_egress_bytes": 296864254351.5304,
    "hit_grad_norm": 0.287538804341266,
    "verification": {"feasible": True, "attempts": 1,
                     "achieved_hit_rate": 0.5012868410128684,
                     "achieved_egress_bytes": 297305787897.0,
                     "executor": "batched"}}
J2_COUNTERS = {"requests": 8000, "bytes_moved": 5761154424525,
               "cache_hits": 169177, "cache_misses": 166967,
               "origin_egress_bytes": 1563103135576,
               "parent_fill_bytes": 2555901468307, "evictions": 0,
               "bytes_evicted": 0}
J2_PLAN = {
    "capacities": [
        490459522872.6274, 83081878299.6728, 143053617482.42682,
        127317420012.1032, 107694972163.80473, 106332383080.86858,
        138528406405.06018, 465427609673.89746, 159635089623.91534,
        90036601003.43587, 109487806890.58197, 74710481396.12071,
        108056963258.0707, 98473148349.76677, 521484076966.74774,
        152353068500.7699, 93527693179.72717, 109294498492.92677,
        131410237652.15054, 140931294336.08618, 121025993900.48015,
        441820852443.6459, 94569916185.10472, 124186923110.8438,
        115136755856.58337, 130603850568.1721, 78428651537.26866,
        120448357701.92949],
    "uniform_capacity": 338699961210.30493,
    "savings_vs_uniform": 0.506778163710123,
    "predicted_hit_rate": 0.502,
    "predicted_egress_bytes": 1563122715132.739,
    "hit_grad_norm": 0.0021139635978875385}
J2_BUDGET_PLAN = {
    "capacities": [
        537266966324.236, 82588522926.44, 142297434785.36624,
        126568261900.97823, 107086874540.06519, 105734153744.01408,
        138588982865.59183, 500970538489.16595, 158981951964.98578,
        89495428028.85974, 108904967049.18831, 74261222119.76555,
        107511960070.74329, 97886735556.11111, 576968233662.64,
        151687743278.52057, 93052970943.13922, 109061357274.3619,
        130685518469.40271, 140430191564.4224, 146344419787.16797,
        488056909790.9634, 94020593185.6168, 123572805850.8036,
        115396158403.42513, 130045695683.54071, 80169182629.37611,
        119810711328.21431],
    "uniform_capacity": 516237019901.659,
    "savings_vs_uniform": 0.6625687216070524,
    "predicted_hit_rate": 0.502,
    "predicted_egress_bytes": 1563106167527.886,
    "hit_grad_norm": 0.0020477710665799307}
J2_EGRESS_AT_MAX = 1563103135576.0
J2_VERIFICATION = {"feasible": True, "attempts": 1,
                   "achieved_hit_rate": 0.502663707322001,
                   "achieved_egress_bytes": 1563103135576.0,
                   "executor": "batched"}
J3_LOSS = [   # each of J2's 28 histograms, in cache-name order
    8.985795011370367e-05, 0.0001173403264536766, 0.00015713471434355706,
    0.00011654411900581367, 0.00015482143538121939, 0.0001505207448380738,
    0.00013478737361058717, 6.419141876941173e-05, 9.440682484790361e-05,
    8.25071083827271e-05, 0.00015625112864179147, 0.0001395971635969277,
    0.00012541663921387708, 8.924941922777326e-05, 7.765069128242567e-05,
    0.00012353675422590058, 0.00017895093578457438, 0.00014458062776532621,
    9.280006535714703e-05, 0.00014158680587340584, 9.583906184593765e-05,
    6.37681163275037e-05, 0.00011015318256922452, 7.20887108252642e-05,
    0.00013190515826581992, 0.00013329707451507417, 9.832684893444572e-05,
    0.00010803183213436114]
PLAN_KEYS = ("uniform_capacity", "predicted_hit_rate",
             "predicted_egress_bytes", "hit_grad_norm")


def _hetero_spec(core, device):
    """``benchmarks/bench_plan.py``'s ``planner_scenario(quick=False)``:
    pod0 700 zipf-1.6 requests over 6 objects, pod1 150 zipf-1.05 over
    64."""
    fed = core.FederationSpec.fleet(num_pods=2, hosts_per_pod=2,
                                    cache_capacity=2e9)
    wl = (core.generate_workload([fed.sites[0].name], 700, seed=0,
                                 working_set=6, zipf_a=1.6)
          + core.generate_workload([fed.sites[1].name], 150, seed=1,
                                   working_set=64, zipf_a=1.05))
    wl.sort(key=lambda r: r.time)
    return core.ScenarioSpec(name="plan-hetero", engine="analytic",
                             federation=fed, workload=wl, device=device)


def _osdf_spec(core, device):
    """The OSDF's two tiers (arXiv:2007.01408) at 4 regions x 6 edges: 24
    L1 edges under 4 L2 backbones, a day of zipf traffic."""
    return core.ScenarioSpec(
        name="plan-osdf", engine="analytic",
        federation=core.FederationSpec.osdf(regions=OSDF_REGIONS,
                                            edges_per_region=OSDF_EDGES),
        workload=core.WorkloadSpec(kind="zipf", n_requests=OSDF_REQUESTS,
                                   working_set=1000, duration=86400.0),
        device=device)


def _plan_errors(got, want, gsize) -> dict:
    """How far a solve's output (G + 4,) is from another's: each
    capacity, the total, the uniform capacity, the egress and the gradient
    norm relative, the hit rate absolute."""
    import numpy as np
    G = len(gsize)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    return {"capacity": rel(got[:G], want[:G]),
            "total": rel(gsize @ got[:G], gsize @ want[:G]),
            "uniform": rel(got[G], want[G]),
            "hit": abs(float(got[G + 1] - want[G + 1])),
            "egress": rel(got[G + 2], want[G + 2]),
            "gnorm": rel(got[G + 3], want[G + 3])}


def _plan_close(got, want, gsize):
    err = _plan_errors(got, want, gsize)
    return all(v <= PLAN_RTOL for v in err.values()), err


def _plan_row(plan) -> list:
    return [plan.capacities[g] for g in sorted(plan.capacities)] + [
        plan.telemetry["hit_grad_norm"] if k == "hit_grad_norm"
        else getattr(plan, k) for k in PLAN_KEYS]


def _want_row(want) -> list:
    return list(want["capacities"]) + [want[k] for k in PLAN_KEYS]


def _check_plan(label: str, plan, want) -> dict:
    """A plan of groups of one cache each against the reference's."""
    import numpy as np
    ok, err = _plan_close(_plan_row(plan), _want_row(want),
                          np.ones(len(want["capacities"])))
    err["savings"] = abs(plan.savings_vs_uniform
                         - want["savings_vs_uniform"])
    if not ok or err["savings"] > PLAN_RTOL:
        raise AssertionError(f"{label}: the plan differs from the "
                             f"reference's: {err}")
    return err


def _verification(plan) -> dict:
    return {k: plan.verification[k] for k in (
        "feasible", "attempts", "achieved_hit_rate",
        "achieved_egress_bytes", "executor")}


def _mixture_errors(grid, got, got_loss, want, want_loss) -> dict:
    """Two fits of one grid: parameters (3, K), the fitted CDF on the grid
    (absolute) and the loss (relative)."""
    import torch

    from repro_torch.kernels import cache_model as cm
    g = torch.as_tensor(grid, dtype=torch.float64).cpu()
    got, want = (torch.as_tensor(p, dtype=torch.float64).cpu()
                 for p in (got, want))
    return {"param": float((got - want).abs().max()),
            "cdf": float((cm._mixture_cdf(g, *got)
                          - cm._mixture_cdf(g, *want)).abs().max()),
            "loss": abs(float(got_loss) - float(want_loss))
            / max(abs(float(want_loss)), 1e-300)}


def _mixture_close(err: dict) -> bool:
    return all(err[k] <= MIX_TOL[k] for k in MIX_TOL)


def _plan_bound(n: int, bk: int, g: int, steps: int,
                clock_hz: float) -> dict:
    """The solve's least time: its 2 x 64 + 8·inner + 8 + 1 dependent
    evaluations, each at least a lane's buckets and a warp's tree (a warp
    a cache), the totals' lane-strided sum and tree, and a barrier, at one
    clock a step; its float64 operations (10 a bucket an evaluation) at
    the card's FP64 rate; its bytes read and written once."""
    import math
    evals = 2 * 64 + 8 * max(steps // 8, 1) + 8 + 1
    per_eval = (math.ceil(bk / 32) + 5) + (math.ceil(n / 32) + 5) + 1
    chain_ms = 1e3 * evals * per_eval / clock_hz
    ops_ms = 1e3 * evals * n * bk * 10 / FP64_FLOPS
    nbytes = 8 * (3 * n * bk + 3 * n + 2 * g + 8 + g + 4) + 8 * n
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    bound = max(chain_ms, ops_ms, bytes_ms)
    return {"chain_ms": chain_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": bound, "evaluations": evals,
            "bound_by": "bytes" if bound == bytes_ms else "operations"}


def _mixture_bound(fits: int, m: int, k: int, steps: int,
                   clock_hz: float) -> dict:
    """The fits' least time: ``steps`` dependent steps, each at least the
    components' loop, a warp's tree, the warps' sum and two barriers at one
    clock a step; 12 float64 operations a point and component a step at
    the FP64 rate; the bytes read and written once."""
    import math
    warps = math.ceil(m / 32)
    chain_ms = 1e3 * steps * (k + 5 + warps + 3) / clock_hz
    ops_ms = 1e3 * fits * steps * m * k * 12 / FP64_FLOPS
    bytes_ms = 1e3 * fits * 8 * (6 * k + 2 * m + 1) / HBM_BYTES_PER_S
    bound = max(chain_ms, ops_ms, bytes_ms)
    return {"chain_ms": chain_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if bound == bytes_ms else "operations"}


def _plan_args(spec, tiled: int = 1):
    """``plan_solve``'s inputs for the plan ``spec`` on the card, its
    caches tiled ``tiled`` times (a group each), and the groups' sizes."""
    import numpy as np
    import torch

    from repro_torch.core import planner
    _, _, st, gidx, gsize = planner.plan_problem(spec)
    inp = planner.solve_inputs(st, gidx, gsize, spec)
    if tiled > 1:
        n = len(gidx)
        inp["stacked"] = np.tile(inp["stacked"], (1, 1, tiled, 1))
        inp["per_cache"] = np.tile(inp["per_cache"], (1, 1, tiled))
        inp["gidx"] = np.arange(n * tiled, dtype=np.int64)[None]
        inp["gsize"] = np.ones((1, n * tiled))
    return [torch.from_numpy(np.ascontiguousarray(inp[k])).cuda()
            for k in ("stacked", "per_cache", "gidx", "gsize",
                      "scalars")], inp["gsize"][0]


def _host_ms(fn, iters: int) -> float:
    """ms a call by the host clock around synchronised calls."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_planner(card: str) -> dict:
    """J: the planner on the card.  J1, the reference CI's planner gate
    (``bench_plan.py``'s heterogeneous scenario at its full profile): a
    fit sweep, a plan at target 0.5 and its verification.  J2, the OSDF's
    two tiers at 28 caches under a day of traffic: the fit sweep, a plan,
    a plan under an egress budget and the first plan's verification.  J3,
    the same sweep fitting mixtures (one ``mixture_fit`` launch a
    kernel round: the edges', then the backbones').  Everything against
    the reference's numbers, each kernel against its plain version on
    the card, with controls; the kernels' and the paths' times.  Returns the kernels' numbers."""
    import numpy as np
    import torch

    import repro_torch.core as core
    from repro_torch.kernels import cache_model as cm
    from repro_torch.kernels import maxmin, ref

    warm = core.run_sweep(core.SweepSpec(
        name="warm", base=_hetero_spec(core, "cuda"), axes={}),
        fit="mixture")
    core.plan_capacity(core.PlannerSpec(models=warm.fitted_models(),
                                        target_hit_rate=PLAN_TARGET))
    _reset_counts()                       # J's path starts here
    wall = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    h_base = _hetero_spec(core, None)
    h_rep = timed("J1 fit sweep", lambda: core.run_sweep(core.SweepSpec(
        name="j1", base=h_base, axes={}), fit=True))
    h_models = h_rep.fitted_models()
    j1_plan = timed("J1 plan_capacity", lambda: core.plan_capacity(
        core.PlannerSpec(models=h_models, target_hit_rate=PLAN_TARGET,
                         groups=core.groups_for_federation(
                             h_base.federation.build(), h_models))))
    j1_ver = timed("J1 verify_plan",
                   lambda: core.verify_plan(j1_plan, h_base))
    o_base = _osdf_spec(core, None)
    with _SweepRecorder(scans=False) as j2_rec:
        o_rep = timed("J2 fit sweep", lambda: core.run_sweep(
            core.SweepSpec(name="j2", base=o_base, axes={}), fit=True))
    models = o_rep.fitted_models()
    spec = core.PlannerSpec(models=models, target_hit_rate=PLAN_TARGET,
                            groups=core.groups_for_federation(
                                o_base.federation.build(), models))
    plan = timed("J2 plan_capacity", lambda: core.plan_capacity(spec))
    stacked = cm.stack_models(models)
    egress_max = float(cm.fleet_origin_egress(stacked, torch.full(
        (len(stacked.names),), spec.max_capacity,
        dtype=torch.float64).cuda()))
    bspec = dataclasses.replace(spec, target_egress_bytes=0.5 * (
        egress_max + plan.predicted_egress_bytes))
    bplan = timed("J2 budget plan_capacity",
                  lambda: core.plan_capacity(bspec))
    ver = timed("J2 verify_plan", lambda: core.verify_plan(plan, o_base))
    with _SweepRecorder(scans=False, fits=True) as j3_rec:
        m_rep = timed("J3 mixture fit sweep", lambda: core.run_sweep(
            core.SweepSpec(name="j3", base=o_base, axes={}), fit="mixture"))
    launches = {"plan_solve": cm.PLAN_SOLVE.launches,
                "mixture_fit": cm.MIXTURE_FIT.launches,
                "maxmin_waterfill": maxmin.WATERFILL.launches}
    waterfill_designs = dict(maxmin.WATERFILL.launches_by_design)  # ... ends

    streams = m_rep.solver["fit_streams"]
    fit_rounds = m_rep.solver.get("tier_rounds", 1)
    if launches["plan_solve"] != 3:
        raise AssertionError(f"J: plan_solve launches {launches}: one a "
                             f"plan (3)")
    if launches["mixture_fit"] != fit_rounds or fit_rounds != 2 or \
            streams != len(J3_LOSS):
        raise AssertionError(f"J: {launches['mixture_fit']} mixture_fit "
                             f"launches for {streams} streams: one a kernel "
                             f"round ({fit_rounds})")
    # J1: the reference CI's gate
    e1 = _check_plan("J1", j1_plan, J1_WANT)
    if _verification(j1_ver) != J1_WANT["verification"]:
        raise AssertionError(f"J1 verification {_verification(j1_ver)}, "
                             f"the reference's {J1_WANT['verification']}")
    if j1_ver.savings_vs_uniform <= SAVINGS_FLOOR:
        raise AssertionError(f"J1 savings {j1_ver.savings_vs_uniform} "
                             f"<= {SAVINGS_FLOOR}")
    say(f"J1 (bench_plan's heterogeneous scenario, full profile, device "
        f"cuda): fit sweep {wall['J1 fit sweep']:.2f} s, plan_capacity "
        f"{1e3 * wall['J1 plan_capacity']:.2f} ms, verify_plan "
        f"{wall['J1 verify_plan']:.2f} s (host clock); capacities "
        f"{_plan_row(j1_plan)[:2]} B, uniform "
        f"{j1_plan.uniform_capacity:.2f} B, savings "
        f"{j1_ver.savings_vs_uniform:.5f} (> {SAVINGS_FLOOR}); within "
        f"{PLAN_RTOL:g} of the reference's (worst {max(e1.values()):.2e}); "
        f"verification {_verification(j1_ver)} equal to the reference's",
        card)
    if waterfill_designs["global"] < 1:
        raise AssertionError(f"J: waterfill launches by design "
                             f"{waterfill_designs}: J2's pricing bucket "
                             f"keeps its lists in device memory")
    # J2: counters, plans, verification
    counters = {k: o_rep.cells[0].summary[k] for k in J2_COUNTERS}
    if counters != J2_COUNTERS:
        raise AssertionError(f"J2 counters {counters}, the reference's "
                             f"{J2_COUNTERS}")
    nofit = timed("J2 sweep without fit", lambda: core.run_sweep(
        core.SweepSpec(name="j2", base=o_base, axes={})))
    fit_summary = dict(o_rep.cells[0].summary, name=None)
    for label, other in (("without fit", nofit), ("fit='mixture'", m_rep)):
        if dict(other.cells[0].summary, name=None) != fit_summary:
            raise AssertionError(f"J2: the sweep {label} has other "
                                 f"counters than the fit sweep")
    if m_rep.reuse_histograms() != o_rep.reuse_histograms():
        raise AssertionError("J3: the mixture sweep's histograms differ "
                             "from the fit sweep's")
    if abs(egress_max / J2_EGRESS_AT_MAX - 1.0) > PLAN_RTOL:
        raise AssertionError(f"J2 egress at max_capacity {egress_max}, the "
                             f"reference's {J2_EGRESS_AT_MAX}")
    e2 = _check_plan("J2", plan, J2_PLAN)
    e2b = _check_plan("J2 budget", bplan, J2_BUDGET_PLAN)
    shift = BUDGET_SHIFT * (plan.predicted_egress_bytes - egress_max)
    ok, budget_cerr = _plan_close(
        _plan_row(core.plan_capacity(dataclasses.replace(
            bspec, target_egress_bytes=bspec.target_egress_bytes + shift))),
        _want_row(J2_BUDGET_PLAN), np.ones(len(J2_PLAN["capacities"])))
    if ok:
        raise AssertionError(f"J2 budget control: a plan under a budget "
                             f"moved by {shift:.1f} B passed the check "
                             f"against the reference's budget plan")
    if _verification(ver) != J2_VERIFICATION:
        raise AssertionError(f"J2 verification {_verification(ver)}, the "
                             f"reference's {J2_VERIFICATION}")
    clock_hz = _max_sm_clock_hz()
    pricing = _solver_numbers("J2", j2_rec.pricing, card, clock_hz,
                              design="global")
    pricing["launches"] = launches["maxmin_waterfill"]
    pricing["launches_by_design"] = waterfill_designs
    say(f"J2 (FederationSpec.osdf, {len(OSDF_REGIONS)} regions x "
        f"{OSDF_EDGES} edges: {len(models)} caches; zipf "
        f"{OSDF_REQUESTS} requests over a day; device cuda; the pricing's "
        f"waterfill launches on J's path by design {waterfill_designs}): "
        f"counters equal "
        f"the reference's {J2_COUNTERS} and the sweep's without fit; fit "
        f"sweep {wall['J2 fit sweep']:.2f} s against "
        f"{wall['J2 sweep without fit']:.2f} s without fit (host clock); "
        f"plan savings {plan.savings_vs_uniform:.6f}, within {PLAN_RTOL:g} "
        f"of the reference's (worst {max(e2.values()):.2e}); budget "
        f"{bspec.target_egress_bytes:.1f} B (halfway from {egress_max:.1f} "
        f"B at max_capacity): savings {bplan.savings_vs_uniform:.6f}, "
        f"within {PLAN_RTOL:g} of the reference's: {e2b}; control (the "
        f"budget moved by {shift:.1f} B, {BUDGET_SHIFT:g} of its span) "
        f"fails: {budget_cerr}; verify_plan "
        f"{wall['J2 verify_plan']:.2f} s, {_verification(ver)} equal to "
        f"the reference's", card)

    _say_solver("J2", pricing, card)

    # plan_solve against its plain version on the card

    kernel = cm.PLAN_SOLVE
    cases = {}
    for label, sp, tiled in (("J2", spec, 1), ("J2 budget", bspec, 1),
                             ("252 caches", spec, PLAN_TILE)):
        args, gsize = _plan_args(sp, tiled)
        got = kernel(*args, sp.steps)
        again = kernel(*args, sp.steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref.plan_solve_ref(*args, sp.steps)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        ok, err = _plan_close(got[0].cpu().numpy(), want[0].cpu().numpy(),
                              gsize)
        if not ok:
            raise AssertionError(f"J {label}: plan_solve differs from its "
                                 f"plain version on the card: {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"J {label}: two plan_solve launches "
                                 f"differ")
        n, bk = args[0].shape[2], args[0].shape[3]
        g = args[3].shape[1]
        case = {"caches": n, "buckets": bk, "groups": g,
                "smem_bytes": kernel.smem_bytes(n, g),
                "threads": kernel.threads(n, g),
                "cluster": kernel.cluster(n, g), "errors": err,
                "max_abs_err": float((got - want).abs().max()),
                "iters": 20 if n < 100 else 5,
                "plain_ms": plain_ms, "library_ms": None,
                **_plan_bound(n, bk, g, sp.steps, clock_hz)}
        case["ms"] = time_ms(lambda: kernel(*args, sp.steps), case["iters"])
        case["graph_ms"] = graph_ms(lambda: kernel(*args, sp.steps))
        if label != "J2 budget":
            cpu = [a.cpu() for a in args]
            t0 = time.perf_counter()
            ref.plan_solve_ref(*cpu, sp.steps)
            case["cpu_plain_ms"] = 1e3 * (time.perf_counter() - t0)
        cases[label] = case
        say(f"J plan_solve {label} (N {n}, Bk {bk}, G {g}, "
            f"{case['smem_bytes']} B of shared memory on each of a cluster "
            f"of {case['cluster']} CTAs of {case['threads']} threads): "
            f"kernel {case['ms']:.4f} ms (CUDA "
            f"events around {case['iters']} calls), {case['graph_ms']:.4f} "
            f"ms (a CUDA "
            f"graph of 20 launches); plain version on the card "
            f"{plain_ms:.1f} ms" + (f", on the CPU "
                                    f"{case['cpu_plain_ms']:.1f} ms"
                                    if "cpu_plain_ms" in case else "")
            + f" (host clock); bound {case['bound_ms']:.6f} ms by "
            f"{case['bound_by']} (chain {case['chain_ms']:.6f} ms over "
            f"{case['evaluations']} evaluations at {clock_hz / 1e6:.0f} MHz;"
            f" FP64 {case['ops_ms']:.6f} ms; bytes {case['bytes_ms']:.6f} "
            f"ms); against the plain version {err}; two launches equal",
            card)
    control = core.plan_capacity(dataclasses.replace(
        spec, target_hit_rate=PLAN_TARGET + 0.001))
    ok, plan_cerr = _plan_close(_plan_row(control), _want_row(J2_PLAN),
                                np.ones(len(J2_PLAN["capacities"])))
    if ok:
        raise AssertionError("J2 control: a plan at target + 0.001 passed "
                             "the check against the reference's plan")
    whole_ms = _host_ms(lambda: core.plan_capacity(spec), 10)
    say(f"J plan_capacity whole at J2 (host clock, 10 calls): {whole_ms:.3f}"
        f" ms a plan, the kernel {cases['J2']['ms']:.4f} of it; control "
        f"(target + 0.001) fails the check: {plan_cerr}", card)
    evaluators = _evaluators(stacked, spec.max_capacity, card)

    # mixture_fit: per stream (the sweep's launches) and batched
    hists = o_rep.reuse_histograms()
    names = sorted(hists)
    problems = [cm.mixture_problem(cm.ReuseHistogram.from_dict(hists[n]))
                for n in names]
    batch = [torch.from_numpy(np.stack([p[i] for p in problems])).cuda()
             for i in range(3)]
    mix = cm.MIXTURE_FIT
    got_b, loss_b = mix(*batch, MIX_STEPS, MIX_LR)
    again_b, again_l = mix(*batch, MIX_STEPS, MIX_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_b, wloss_b = ref.mixture_fit_ref(*batch, MIX_STEPS, MIX_LR)
    torch.cuda.synchronize()
    mix_plain_ms = 1e3 * (time.perf_counter() - t0)
    if not (torch.equal(got_b, again_b) and torch.equal(loss_b, again_l)):
        raise AssertionError("J3: two mixture_fit launches differ")
    fitted = m_rep.fitted_models()
    worst = dict.fromkeys(MIX_TOL, 0.0)
    worst_ref = 0.0
    for i, name in enumerate(names):
        mdl = fitted[name]
        one = np.stack([mdl.mix_logits, mdl.mix_mu, mdl.mix_log_sigma])
        if not np.array_equal(one, got_b[i].cpu().numpy()) or \
                mdl.fit_loss != float(loss_b[i]):
            raise AssertionError(f"J3 {name}: the sweep's fit differs from "
                                 f"the batched launch's")
        err = _mixture_errors(problems[i][1], got_b[i], loss_b[i],
                              want_b[i], wloss_b[i])
        if not _mixture_close(err):
            raise AssertionError(f"J3 {name}: mixture_fit differs from its "
                                 f"plain version on the card: {err}")
        worst = {k: max(worst[k], err[k]) for k in worst}
        rel = abs(mdl.fit_loss / J3_LOSS[i] - 1.0)
        if rel > MIX_TOL["loss"]:
            raise AssertionError(f"J3 {name}: loss {mdl.fit_loss}, the "
                                 f"reference's {J3_LOSS[i]}")
        worst_ref = max(worst_ref, rel)
    moved = [t.clone() for t in batch]
    moved[2][0, 64] += 1e-3
    ctl_p, ctl_l = mix(*[t[:1].contiguous() for t in moved], MIX_STEPS,
                       MIX_LR)
    mix_cerr = _mixture_errors(problems[0][1], ctl_p[0], ctl_l[0],
                               want_b[0], wloss_b[0])
    if _mixture_close(mix_cerr):
        raise AssertionError("J3 control: a fit to a target moved by 1e-3 "
                             "at one point passed the check")
    one = [t[:1].contiguous() for t in batch]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.mixture_fit_ref(*one, MIX_STEPS, MIX_LR)
    torch.cuda.synchronize()
    one_plain_ms = 1e3 * (time.perf_counter() - t0)
    cpu_b = [t.cpu() for t in batch]
    t0 = time.perf_counter()
    ref.mixture_fit_ref(*cpu_b, MIX_STEPS, MIX_LR)
    cpu_plain_ms = 1e3 * (time.perf_counter() - t0)
    m, k = batch[1].shape[1], batch[0].shape[2]
    mixture = {
        "stream": {"fits": 1, "ms": time_ms(
            lambda: mix(*one, MIX_STEPS, MIX_LR), 20),
            "graph_ms": graph_ms(lambda: mix(*one, MIX_STEPS, MIX_LR)),
            "plain_ms": one_plain_ms, "library_ms": None,
            **_mixture_bound(1, m, k, MIX_STEPS, clock_hz)},
        "batched": {"fits": len(names), "ms": time_ms(
            lambda: mix(*batch, MIX_STEPS, MIX_LR), 20),
            "graph_ms": graph_ms(lambda: mix(*batch, MIX_STEPS, MIX_LR)),
            "plain_ms": mix_plain_ms, "cpu_plain_ms": cpu_plain_ms,
            "library_ms": None,
            **_mixture_bound(len(names), m, k, MIX_STEPS, clock_hz)},
        "errors": worst, "max_abs_err": float((got_b - want_b).abs().max()),
        "loss_rel_err_reference": worst_ref, "control": mix_cerr,
        "launches": launches["mixture_fit"], "points": m, "components": k,
        "steps": MIX_STEPS}
    # J3's fits as the sweep launches them (a launch a kernel round) and as
    # one launch a stream did before: the rounds' recorded inputs, each
    # launch by CUDA events around 20 calls
    rounds = [args[:3] for args, _ in j3_rec.fits]
    mixture["sweep"] = {
        "launches": [int(r[0].shape[0]) for r in rounds],
        "ms": sum(time_ms(lambda: mix(*r, MIX_STEPS, MIX_LR), 20)
                  for r in rounds),
        "per_stream_ms": len(names) * mixture["stream"]["ms"]}
    for key in ("stream", "batched"):
        c = mixture[key]
        say(f"J3 mixture_fit {key} ({c['fits']} fit(s) of {k} components "
            f"over {m} points, {MIX_STEPS} steps): kernel {c['ms']:.4f} ms "
            f"(CUDA events around 20 calls), {c['graph_ms']:.4f} ms (a CUDA "
            f"graph); plain version on the card {c['plain_ms']:.1f} ms"
            + (f", on the CPU {c['cpu_plain_ms']:.1f} ms"
               if "cpu_plain_ms" in c else "")
            + f" (host clock); bound {c['bound_ms']:.6f} ms by "
            f"{c['bound_by']} (chain {c['chain_ms']:.6f}, FP64 "
            f"{c['ops_ms']:.6f}, bytes {c['bytes_ms']:.6f} ms)", card)
    sw = mixture["sweep"]
    say(f"J3 mixture_fit as the sweep launches it: {len(sw['launches'])} "
        f"launches of {sw['launches']} fits, {sw['ms']:.4f} ms of kernel "
        f"(CUDA events around 20 calls each); one launch a stream, as before "
        f"the batching: {len(names)} x {mixture['stream']['ms']:.4f} = "
        f"{sw['per_stream_ms']:.4f} ms", card)
    say(f"J3 mixture_fit: {launches['mixture_fit']} launches on the mixture "
        f"sweep's path (one a kernel round, for {streams} streams), each "
        f"fit equal to its row of one launch of all {len(names)}; against "
        f"the plain version on the card {worst} (bounds "
        f"{MIX_TOL}); losses within {worst_ref:.2e} of the reference's; "
        f"control (a target point moved by 1e-3) fails: {mix_cerr}; mixture "
        f"sweep {wall['J3 mixture fit sweep']:.2f} s (host clock)", card)
    return {"plan_solve": {"launches": launches["plan_solve"],
                           "cases": cases, "control": plan_cerr,
                           "budget_control": budget_cerr,
                           "plan_capacity_ms": whole_ms,
                           "errors_vs_reference": {"J1": e1, "J2": e2,
                                                   "J2 budget": e2b}},
            "mixture_fit": mixture, "batched_maxmin": pricing,
            "evaluators": evaluators, "wall_s": wall}


def _evaluators(stacked, capacity: float, card: str) -> dict:
    """The eager cache-model evaluators (torch ops, no kernel of their
    own) on their own at J2's 28 stacked models: ``fleet_origin_egress``
    as J calls it once (the egress at ``max_capacity``) and
    ``fleet_hit_rate`` beside it; CUDA events around 20 calls and the
    host clock around 20 calls read back; bound: the models' and the
    capacities' bytes read once at 3.35 TB/s."""
    import numpy as np
    import torch

    from repro_torch.kernels import cache_model as cm
    n, buckets = np.shape(stacked.log_centers)
    caps = torch.full((n,), capacity, dtype=torch.float64).cuda()
    bound_ms = 1e3 * 8 * (2 * n * buckets + 5 * n) / HBM_BYTES_PER_S
    out = {}
    for name in ("fleet_origin_egress", "fleet_hit_rate"):
        fn = getattr(cm, name)
        out[name] = {"ms": time_ms(lambda: fn(stacked, caps), 20),
                     "host_ms": _host_ms(lambda: float(fn(stacked, caps)),
                                         20),
                     "bound_ms": bound_ms, "bound_by": "bytes"}
    say("J evaluators at J2 (" + f"{n} caches x {buckets} buckets, torch "
        "ops): " + "; ".join(
            f"{k} {v['ms']:.4f} ms (CUDA events around 20 calls), "
            f"{v['host_ms']:.4f} ms read back (host clock)"
            for k, v in out.items())
        + f"; bound {bound_ms:.6f} ms (bytes); J calls fleet_origin_egress "
        f"once on its own, plan_capacity's evaluations run inside "
        f"plan_solve", card)
    return out


# Buckets whose flow state exceeds a block's shared memory (the design
# global_flows): flows over 200 links, 1-8 links a flow, as a sweep cell of
# more than 16,384 storm flows would price them; Fp 131072 takes 4-byte
# list entries.
WATERFILL_LARGE = {"Fp 32768": 20000, "Fp 131072": 70000}


def _large_problem(n_flows: int, n_links: int = 200, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    caps = rng.uniform(1e8, 1e10, n_links)
    rows = [rng.choice(n_links, int(rng.integers(1, 9)),
                       replace=False).tolist() for _ in range(n_flows)]
    return caps.tolist(), rows, rng.uniform(1e6, 1e9, n_flows).tolist()


def phase_waterfill_large(card: str) -> dict:
    """The waterfill's largest buckets (``WATERFILL_LARGE``, design
    ``global_flows``): the kernel's rates and round count equal to the
    plain version's on the card bit for bit, two launches equal, and a
    control (the most-shared saturated link halved) whose plain rates
    must differ; the kernel's time (CUDA events) and the plain version's
    (host clock)."""
    import numpy as np
    import torch

    from repro_torch.kernels import maxmin
    dev = torch.device("cuda")
    out = {}
    for label, flows in WATERFILL_LARGE.items():
        caps, rows, fcaps = _large_problem(flows)
        Fp, Lp, width = (maxmin._next_pow2(flows),
                         maxmin._next_pow2(len(caps) + 1), 8)
        design = maxmin.WATERFILL.design(Fp, Lp, width)
        if design != "global_flows":
            raise AssertionError(f"waterfill {label}: design {design}, not "
                                 f"global_flows")
        staging = maxmin.Staging(1, Fp, Lp, width, dev)
        maxmin.pad_problem(caps, rows, fcaps, Fp, Lp, width,
                           out=staging.problem(0))
        args = staging.views(staging.upload())
        before = maxmin.WATERFILL.launches_by_design["global_flows"]
        got = maxmin.WATERFILL(*args)
        again = maxmin.WATERFILL(*args)
        if maxmin.WATERFILL.launches_by_design["global_flows"] != before + 2:
            raise AssertionError(f"waterfill {label}: not launched on "
                                 f"global_flows")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = maxmin.plain_waterfill(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.tobytes() != w.tobytes() or not torch.equal(got, again):
            raise AssertionError(
                f"waterfill {label}: the kernel's rates differ from the "
                f"plain version's (max abs {np.abs(g - w).max()}) or two "
                f"launches differ")
        load = np.zeros(len(caps))
        share = np.zeros(len(caps), np.int64)
        for f, row in enumerate(rows):
            load[row] += w[0, f]
            share[row] += 1
        saturated = np.flatnonzero(load >= 0.999 * np.asarray(caps))
        if not saturated.size:
            raise AssertionError(f"waterfill {label}: no saturated link to "
                                 f"halve for the control")
        halve = int(saturated[np.argmax(share[saturated])])
        ctl_caps = args[0].clone()
        ctl_caps[0, halve] /= 2
        ctl = maxmin.plain_waterfill(ctl_caps, args[1], args[2])
        if torch.equal(got, ctl):
            raise AssertionError(f"waterfill {label}: the control (link "
                                 f"{halve} halved) passed")
        ms = time_ms(lambda: maxmin.WATERFILL(*args), 5)
        out[label] = {
            "bucket": [1, Fp, Lp, width], "flows": flows, "design": design,
            "smem_bytes": maxmin.WATERFILL.smem_bytes(Fp, Lp, width),
            "rounds": int(g[0, Fp]), "ms": ms, "plain_ms": plain_ms,
            "equal_bits": True,
            "control": {"link": halve, "link_flows": int(share[halve]),
                        "changed_rates": int((ctl != got).sum())}}
        say(f"waterfill {label} ({flows} flows over {len(caps)} links, "
            f"bucket (1, {Fp}, {Lp}, {width}), design {design}, "
            f"{out[label]['smem_bytes']} B of shared memory, "
            f"{out[label]['rounds']} rounds): rates and round count equal "
            f"to the plain version's on the card bit for bit, two launches "
            f"equal; control (link {halve}, {int(share[halve])} flows, "
            f"halved) changes {out[label]['control']['changed_rates']} "
            f"rates; kernel {ms:.4f} ms (CUDA events around 5 calls), "
            f"plain version on the card {plain_ms:.1f} ms (host clock)",
            card)
    return out


# buckets whose link state alone exceeds a block's shared memory (design
# global_links): (flows, links, most links a flow), seeded uniform-random
WATERFILL_LINKS = {"Fp 64 Lp 16384": (60, 9000, 4),
                   "Fp 1024 Lp 32768": (1000, 20000, 8)}


def phase_waterfill_links(card: str) -> dict:
    """The waterfill's buckets of 8,192 links or more (``WATERFILL_LINKS``,
    design ``global_links``): rates and round count equal to the plain
    version's on the card bit for bit, two launches equal; control: the
    fastest flow's cap set to half its rate must change the kernel's
    rates, which still equal the plain version's; the kernel's time
    (CUDA events) and the plain version's (host clock)."""
    import numpy as np
    import torch

    from repro_torch.kernels import maxmin
    dev = torch.device("cuda")
    out = {}
    for label, (flows, links, most) in WATERFILL_LINKS.items():
        rng = np.random.default_rng(0)
        caps = rng.uniform(1e8, 1e10, links).tolist()
        rows = [rng.choice(links, int(rng.integers(1, most + 1)),
                           replace=False).tolist() for _ in range(flows)]
        fcaps = rng.uniform(1e6, 1e9, flows).tolist()
        Fp, Lp, width = (maxmin._next_pow2(flows),
                         maxmin._next_pow2(links + 1), most)
        design = maxmin.WATERFILL.design(Fp, Lp, width)
        if f"Fp {Fp} Lp {Lp}" != label or design != "global_links":
            raise AssertionError(f"waterfill {label}: bucket ({Fp}, {Lp}), "
                                 f"design {design}, not global_links")
        staging = maxmin.Staging(1, Fp, Lp, width, dev)
        maxmin.pad_problem(caps, rows, fcaps, Fp, Lp, width,
                           out=staging.problem(0))
        args = staging.views(staging.upload())
        before = maxmin.WATERFILL.launches_by_design["global_links"]
        got = maxmin.WATERFILL(*args)
        again = maxmin.WATERFILL(*args)
        if maxmin.WATERFILL.launches_by_design["global_links"] != before + 2:
            raise AssertionError(f"waterfill {label}: not launched on "
                                 f"global_links")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = maxmin.plain_waterfill(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.tobytes() != w.tobytes() or not torch.equal(got, again):
            raise AssertionError(
                f"waterfill {label}: the kernel's rates differ from the "
                f"plain version's (max abs {np.abs(g - w).max()}) or two "
                f"launches differ")
        fastest = int(np.argmax(w[0, :flows]))
        ctl_fcaps = args[2].clone()
        ctl_fcaps[0, fastest] = want[0, fastest] / 2
        ctl = maxmin.WATERFILL(args[0], args[1], ctl_fcaps)
        if torch.equal(ctl, got) or not torch.equal(
                ctl, maxmin.plain_waterfill(args[0], args[1], ctl_fcaps)):
            raise AssertionError(f"waterfill {label}: the control (flow "
                                 f"{fastest}'s cap halved below its rate) "
                                 f"did not change the rates, or differs "
                                 f"from the plain version")
        ms = time_ms(lambda: maxmin.WATERFILL(*args), 3)
        out[label] = {
            "bucket": [1, Fp, Lp, width], "flows": flows, "links": links,
            "design": design,
            "smem_bytes": maxmin.WATERFILL.smem_bytes(Fp, Lp, width),
            "rounds": int(g[0, Fp]), "ms": ms, "plain_ms": plain_ms,
            "equal_bits": True,
            "control": {"flow": fastest,
                        "changed_rates": int((ctl != got).sum())}}
        say(f"waterfill {label} ({flows} flows over {links} links, bucket "
            f"(1, {Fp}, {Lp}, {width}), design {design}, "
            f"{out[label]['smem_bytes']} B of shared memory, "
            f"{out[label]['rounds']} rounds): rates and round count equal "
            f"to the plain version's on the card bit for bit, two launches "
            f"equal; control (flow {fastest}'s cap halved below its rate) "
            f"changes {out[label]['control']['changed_rates']} rates and "
            f"equals the plain version; kernel {ms:.4f} ms (CUDA events "
            f"around 3 calls), plain version on the card {plain_ms:.1f} ms "
            f"(host clock)", card)
    return out


def _fnv1a_entry(kernel: dict, leg: dict, card: str) -> dict:
    """The digest kernel's line: a 24 MiB chunk; its launches on the
    weight leg."""
    from repro_torch.kernels import fnv1a
    entry = _entry("fnv1a64_chunks", leg["launches"], kernel, "exact",
                   f"one 24 MiB chunk (split: segments of {fnv1a.SEG} B, "
                   f"groups of {fnv1a.GROUP})", card)
    entry.update({k: kernel[k] for k in ("object_ms", "ns_per_byte")})
    entry["check_designs"] = kernel["designs"]
    entry["weight_leg"] = {k: v for k, v in leg.items()
                           if k not in ("launches", "ssd_launches")}
    return entry


def _plan_solve_entry(nums: dict, card: str) -> dict:
    source, replaces = KERNEL_FILES["plan_solve"]
    main = nums["cases"]["J2"]
    return {"name": "plan_solve", "route": "cuda", "source": source,
            "replaces": replaces, "launches": nums["launches"],
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "graph_ms", "cpu_plain_ms", "chain_ms",
                                    "ops_ms", "bytes_ms", "errors",
                                    "cluster", "threads")},
            "tolerance": f"card vs the plain version on the card and vs the "
                         f"reference: {PLAN_RTOL:g} relative, with and "
                         f"without an egress budget",
            "shape": f"J2's plan: {main['caches']} caches x "
                     f"{main['buckets']} buckets, {main['groups']} groups, "
                     f"600 steps, a cluster of {main['cluster']} CTAs",
            "card": card,
            "plan_capacity_ms": nums["plan_capacity_ms"],
            "control": nums["control"],
            "budget_control": nums["budget_control"],
            "errors_vs_reference": nums["errors_vs_reference"],
            "cases": {k: v for k, v in nums["cases"].items() if k != "J2"}}


def _mixture_fit_entry(nums: dict, card: str) -> dict:
    source, replaces = KERNEL_FILES["mixture_fit"]
    main = nums["stream"]
    return {"name": "mixture_fit", "route": "cuda", "source": source,
            "replaces": replaces, "launches": nums["launches"],
            "max_abs_err": nums["max_abs_err"],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "graph_ms", "chain_ms",
                                    "ops_ms", "bytes_ms")},
            "tolerance": f"card vs the plain version on the card {MIX_TOL}; "
                         f"losses vs the reference's {MIX_TOL['loss']:g} "
                         f"relative",
            "shape": f"one of J2's histograms: {nums['components']} "
                     f"components over {nums['points']} points, "
                     f"{nums['steps']} steps",
            "card": card, "errors": nums["errors"],
            "loss_rel_err_reference": nums["loss_rel_err_reference"],
            "control": nums["control"], "batched": nums["batched"],
            "sweep": nums["sweep"]}


def _scan_entry(name: str, nums: dict, card: str) -> dict:
    entry = _entry(name, nums["launches"], nums, "exact",
                   f"sweep I's largest bucket {nums['bucket']} (B, Np"
                   f"{'' if name == 'stack_distance' else ', Kp'}), "
                   f"{nums['problems']} problems, {nums['refs']} "
                   f"references", card)
    entry.update({k: nums[k] for k in ("buckets", "problems_checked",
                                       "event_ms_per_launch", "bytes_ms",
                                       "chain_ms", "us_per_step", "control",
                                       "launches_by_design", "oversize")
                     if k in nums})
    return entry


def _batched_maxmin_entry(nums: dict, planner: dict, large: dict,
                          card: str) -> dict:
    """Sweep I's pricing bucket; beside it J2's largest bucket of the
    design ``global`` and the buckets of the design ``global_flows``.
    ``launches`` sums the two paths' launches."""
    source, replaces = KERNEL_FILES["batched_maxmin"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_rel_err_cpu", "cpu_plain_ms", "bytes_ms",
            "chain_ms", "max_rounds", "design", "problems_checked",
            "control")
    return {"name": "batched_maxmin", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": nums["launches"] + planner["launches"],
            **{k: nums[k] for k in keys + ("rounds", "syncs", "host_s")},
            "tolerance": f"card vs the plain version on the CPU "
                         f"{MAXMIN_CPU_RTOL} relative; storm finish "
                         f"seconds vs the reference's {SOLVER_RTOL}",
            "shape": f"sweep I's pricing bucket {nums['bucket']} (B, Fp, "
                     f"Lp, width)", "card": card,
            "launches_by_path": {"sweep I": nums["launches"],
                                 "planner J": planner["launches"]},
            "J2_case": {"shape": f"J2's pricing bucket {planner['bucket']} "
                                 f"(B, Fp, Lp, width)",
                        "launches_by_design": planner["launches_by_design"],
                        **{k: planner[k] for k in keys}},
            "large_buckets": large}


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
                                    "tc_bound_ms", "tc_bound_by",
                                    "host_ms", "with_host_ms",
                                    "largest_leaf_ms") if k in case}}


def _maxmin_entry(storm: dict, card: str) -> dict:
    """The max-min kernel's line; its main case is storm H's peak solve."""
    peak = storm["snapshots"]["peak"]
    source, replaces = KERNEL_FILES["maxmin"]
    return {"name": "maxmin", "route": "cuda", "source": source,
            "replaces": replaces, "launches": storm["launches"],
            **{k: peak[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "bytes_ms", "chain_ms", "host_ms",
                                    "split_ms", "cpu_plain_ms",
                                    "scalar_ms",
                                    "max_rel_err_oracle", "rounds")},
            "tolerance": f"card vs the plain version on the CPU and on the "
                         f"card {MAXMIN_CPU_RTOL} relative; vs maxmin_ref "
                         f"rtol {MAXMIN_REF_RTOL}, atol {MAXMIN_REF_ATOL:g}",
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
    fnv = phase_fnv_kernel(card)
    gemma_flash = phase_serve_gemma(card, flash)
    _free()
    ssd_launches, mamba_sums, checksum = phase_serve_mamba(card, ssd)
    _free()
    mixtral_flash, mixtral_sums, mixtral_checksum = phase_serve_mixtral(
        card, flash)
    _free()
    leg = phase_weight_leg(card, ssd)
    _free()
    qwen2_flash = phase_serve_qwen2(card, flash)
    _free()
    new_flash = {}
    for arch, phase in (("deepseek-coder-33b", phase_serve_deepseek),
                        ("phi3.5-moe-42b-a6.6b", phase_serve_phi35_moe),
                        ("phi3-mini-3.8b", phase_serve_phi3_mini),
                        ("musicgen-medium", phase_serve_musicgen)):
        new_flash[arch] = phase(card, flash)
        _free()
    jamba = phase_serve_jamba(card, flash, ssd)
    _free()
    llama = phase_serve_llama(card, flash)
    _free()
    new_flash.update({
        "jamba-1.5-large-398b": jamba["flash"],
        "llama-3.2-vision-90b": llama["flash"],
        "llama-3.2-vision-90b cross-attention": llama["then"]["launches"]})
    phase_launcher(card)
    backward = phase_flash_backward(card)
    ssd_backward = phase_ssd_backward(card)
    _free()
    small_trains = {arch: phase_train_small(card, arch, leaf, kernel)
                    for arch, leaf, kernel in SMALL_TRAINS}
    _free()
    trains = {}
    for arch, layers, batch, seq, steps in TRAIN_PHASES:
        trains[arch] = phase_train(card, arch, layers, batch, seq, steps)
        _free()
    launcher_train = phase_launcher_train(card)
    phase_federation_paper(card)
    storm = phase_federation_storm(card)
    sweep = phase_sweep(card)
    plans = phase_planner(card)
    large = phase_waterfill_large(card)
    large.update(phase_waterfill_links(card))
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s (the full-width training "
        f"phases {sum(t['phase_s'] for t in trains.values()):.1f} s of it)",
        card)
    # launches: the sum over the paths that run the kernel
    train_flash = {f"{arch} training": t["launches"]["forward"]
                   for arch, t in trains.items() if t["launches"]["forward"]}
    train_bwd = {f"{arch} training": t["launches"]["backward"]
                 for arch, t in trains.items() if t["launches"]["backward"]}
    train_ssd = {f"{arch} training": t["launches"]["ssd_forward"]
                 for arch, t in trains.items() if t["launches"]["ssd_forward"]}
    train_ssd_bwd = {f"{arch} training": t["launches"]["ssd_backward"]
                     for arch, t in trains.items()
                     if t["launches"]["ssd_backward"]}
    flash_entry = _entry("flash_attention",
                         gemma_flash + mixtral_flash + qwen2_flash
                         + sum(new_flash.values())
                         + sum(train_flash.values()),
                         flash[MAIN_CASE], TOLERANCE["bfloat16"], MAIN_CASE,
                         card)
    flash_entry["launches_by_path"] = {"gemma2-2b": gemma_flash,
                                       "mixtral-8x22b": mixtral_flash,
                                       "qwen2-7b": qwen2_flash, **new_flash,
                                       **train_flash}
    backward_entry = _entry("flash_attention_backward",
                            sum(train_bwd.values()),
                            backward[BWD_MAIN_CASE], TOLERANCE["bfloat16"],
                            BWD_MAIN_CASE, card)
    backward_entry["launches_by_path"] = train_bwd
    backward_entry["launches_by_design"] = {
        design: sum(t["launches"]["backward_by_design"][design]
                    for t in trains.values())
        for design in ("wgmma", "simt")}
    backward_entry["cases"] = [_case(case, name)
                               for name, case in backward.items()
                               if name != BWD_MAIN_CASE]
    training = {
        arch: {k: t[k] for k in (
            "layers", "batch", "seq", "steps", "parameters", "state_gb",
            "step_ms", "first_step_ms", "tokens_per_s", "peak_gb",
            "check_peak_gb", "flash_forward_ms", "flash_backward_ms",
            "ssd_forward_ms", "ssd_backward_ms", "optimizer_ms", "rest_ms",
            "phase_s", "loss_rel", "gnorm_rel", "gnorm_reversed_rel",
            "attn_grad_off", "attn_grad_reversed_off",
            "attn_grad_control_off", "ssm_grad_off",
            "ssm_grad_reversed_off", "ssm_grad_control_off",
            "routes_flipped", "losses")}
        for arch, t in trains.items()}
    backward_entry["training"] = training
    backward_entry["small_train"] = small_trains["qwen2-7b"]
    backward_entry["launcher_replay_bit_equal"] = launcher_train["bit_equal"]
    flash_entry["backward_case"] = _case(
        backward[BWD_MAIN_CASE], BWD_MAIN_CASE,
        launches=train_bwd["qwen2-7b training"])
    flash_entry["hd128_case"] = _case(flash[MAIN_CASE_128], MAIN_CASE_128,
                                      launches=mixtral_flash)
    flash_entry["hd96_case"] = _case(flash[MAIN_CASE_96], MAIN_CASE_96,
                                     launches=new_flash["phi3-mini-3.8b"])
    flash_entry["hd64_case"] = _case(flash[MAIN_CASE_64], MAIN_CASE_64,
                                     launches=new_flash["musicgen-medium"])
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
    ssd_entry = _entry("ssd_intra", ssd_launches + leg["ssd_launches"]
                       + jamba["ssd_intra"] + sum(train_ssd.values()),
                       ssd[SSD_MAIN_CASE], SSD_TOLERANCE,
                       f"{SSD_MAIN_CASE} float32", card)
    ssd_entry["launches_by_path"] = {"mamba2-780m": ssd_launches,
                                     "weight leg": leg["ssd_launches"],
                                     "jamba-1.5-large-398b":
                                         jamba["ssd_intra"], **train_ssd}
    ssd_entry["p128_case"] = _case(ssd[SSD_P128_CASE],
                                   f"{SSD_P128_CASE} float32",
                                   launches=jamba["ssd_intra"])
    ssd_backward_entry = _entry(
        "ssd_intra_backward", sum(train_ssd_bwd.values()),
        ssd_backward[SSD_BWD_MAIN_CASE],
        f"{SSD_BWD_TOL:g} of each output's largest magnitude, against the "
        f"plain version in float64", f"{SSD_BWD_MAIN_CASE} float32", card)
    ssd_backward_entry["launches_by_path"] = train_ssd_bwd
    ssd_backward_entry["launches_by_design"] = {
        design: sum(t["launches"]["ssd_backward_by_design"][design]
                    for t in trains.values())
        for design in ("simt_p64", "simt_p128", "simt")}
    ssd_backward_entry["cases"] = [
        _case(case, name, plain_f32_off=case["plain_f32_off"],
              control_dcum_off=case["control_dcum_off"],
              control_nudged_off=case["control_nudged_off"])
        for name, case in ssd_backward.items() if name != SSD_BWD_MAIN_CASE]
    ssd_backward_entry["training"] = {
        arch: training[arch] for arch, t in trains.items()
        if t["launches"]["ssd_backward"]}
    ssd_backward_entry["small_train"] = small_trains["mamba2-780m"]
    print(json.dumps({"kernels": [
        flash_entry,
        backward_entry,
        ssd_entry,
        ssd_backward_entry,
        checksum_entry,
        _maxmin_entry(storm, card),
        *[_scan_entry(name, sweep[name], card) for name in SCANS],
        _batched_maxmin_entry(sweep["batched_maxmin"],
                              plans["batched_maxmin"], large, card),
        _plan_solve_entry(plans["plan_solve"], card),
        _mixture_fit_entry(plans["mixture_fit"], card),
        _fnv1a_entry(fnv, leg, card),
    ]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
