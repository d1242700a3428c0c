#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--out FILE]

Phases, each fatal on failure (exit code != 0, no result line):
  1. card: name and power limit (nvidia-smi), then build the CUDA kernels
     from src/repro_torch/kernels/csrc (nvcc, sm_90a) and report the time;
  2. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 at the serving paths' shapes (then, untimed, edge cases the
     serving shapes do not reach), with its median time (CUDA events,
     L2 flushed before every launch), the plain version's and one PyTorch
     library call's (a yardstick only; the port never calls it), and its
     bound: the larger of bytes / 3.35 TB/s and operations / peak rate
     (989 TFLOP/s bf16 tensor-core for the attention products, 495 TFLOP/s
     TF32 tensor-core for the SSD scan's f32 products, 67 TFLOP/s f32 for
     rmsnorm's element-wise work).  No single PyTorch call computes the
     SSD scan: its yardstick is the port's own plain chunked SSD
     (models.mamba2.ssd_chunked), reported beside library_ms = null.
     Then planted faults: broken copies of the ssd_scan kernel, each with
     one source edit, are built into kernels/build/planted/ and must fail
     the limits that the right kernel meets on the same inputs;
  3. small: each served model's smoke config in f32 runs on the card
     (kernels) and on the CPU (plain versions); the forward logits agree
     within SMALL_TOL and the engines emit the same greedy tokens;
  4. serve, once per model of SERVED, behind repro_torch.serve.ServeEngine
     at its published widths and depth (random weights from seed 0, bf16):
     qwen3-14b (40 layers, d_model 5120), then mamba2-370m (48 layers,
     d_model 1024, 32 SSM heads x 64, state 128); 4 slots of 2048
     positions, 8 requests with prompts of 100-1000 tokens and 32 greedy
     new tokens each.  The kernel launch counts are set to 0 just before
     each run and read just after; every kernel of the path must have run,
     exactly as many times as the path's shape says, and no other.  One
     request's prefill logits are held against the port's forward pass.
     Then one decode step over the 4 slots and one 1024-token prefill are
     timed on the host and traced with torch.profiler (device time by
     kernel, busy share).  Each phase frees its engine and weights before
     the next.
The last lines are the card line, one JSON object with the kernels'
numbers, and {"ok": true, "device": {...}}.  Without a CUDA card, or
without the repository's src/ beside this file, it exits non-zero.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12
F32_FLOPS = 67e12
# Kernel vs plain version on the same inputs: every element within
# atol + rtol |want|, and every output row (the last axis) within
# ||got - want|| / ||want|| <= row_rel.  rtol 1.6e-2 is two bf16 ulps, for
# results that round the other way.  The flash kernel rounds P to bf16 for
# P V, which moves an output by up to 2^-8 max|v| (hence its atol) and a
# row by ~4e-3; the others keep f32 to the last rounding.  The SSD scan
# has two outputs, each with its own limits: y (bf16, rounded once from
# f32) and the final state (f32, sums in another order than the plain
# sequential recurrence).
TOL = {"rmsnorm": (1e-3, 1.6e-2, 2e-3),
       "flash_attention": (1e-2, 1.6e-2, 1e-2),
       "decode_attention": (2e-3, 1.6e-2, 2e-3),
       "ssd_scan.y": (1e-3, 1.6e-2, 4e-3),
       "ssd_scan.state": (1e-3, 1e-3, 1e-4)}
OUTPUTS = {"ssd_scan": ("y", "state")}    # kernels with more than one output
LOGITS_REL_TOL = 5e-2    # prefill vs forward logits, max |diff| / max |logit|
SMALL_TOL = 1e-3         # f32 logits, card vs CPU (sums in another order)

DEVICE = "cuda"
SERVED = ("qwen3-14b", "mamba2-370m")
N_SLOTS, MAX_SEQ, N_REQ, NEW_TOKENS = 4, 2048, 8, 32
PROMPT_MIN, PROMPT_MAX = 100, 1000


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("chip_smoke: " + what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, flush, reps: int = 10, per_rep: int = 10) -> float:
    """Median device time of one fn() in ms.  Each rep flushes L2, parks the
    card on a ~2 ms spin so that the host can queue `per_rep` launches, and
    times them back to back with CUDA events: host launch latency stays out
    of the number, and only the first launch of a rep finds L2 cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def errors(got, want) -> tuple[float, float]:
    """(max abs error, max relative L2 error of an output row)."""
    g, w = got.float(), want.float()
    rows = ((g - w).flatten(0, -2).norm(dim=-1)
            / w.flatten(0, -2).norm(dim=-1).clamp_min(1e-30))
    return float((g - w).abs().max()), float(rows.max())


def within(got, want, tol_key: str) -> bool:
    atol, rtol, row_rel = TOL[tol_key]
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all()) and \
        errors(got, want)[1] <= row_rel


def compare(got, want, name: str, what: str) -> tuple[float, float]:
    """Hold a kernel's output against its plain version with TOL[name];
    print and return (max abs error, max row relative error)."""
    atol, rtol, row_rel = TOL[name]
    max_abs, max_row = errors(got, want)
    print(f"{what}: max_abs_err {max_abs:.3e} (tol {atol} + {rtol} |want|) "
          f"max_row_rel_err {max_row:.3e} (tol {row_rel})", flush=True)
    require(within(got, want, name), f"{what} disagrees with its plain version")
    return max_abs, max_row


def hold(name: str, got, want, what: str) -> dict:
    """compare() each output of a kernel: {output: (max abs, max row rel)}."""
    if name not in OUTPUTS:
        return {"": compare(got, want, name, what)}
    return {part: compare(g, w, f"{name}.{part}", f"{what} {part}")
            for part, g, w in zip(OUTPUTS[name], got, want)}


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ssd_inputs(torch, F, gen, B, L, H, P, N, dtype):
    """SSD scan inputs as the mamba2 layer makes them: dt from softplus, A
    from the reference's -exp(linspace(log 1, log 16)), one B/C group."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    A = -torch.exp(torch.linspace(0.0, math.log(16.0), H, device="cuda"))
    return (randn(B, L, H, P).to(dtype), F.softplus(randn(B, L, H)), A,
            randn(B, L, 1, N).to(dtype), randn(B, L, 1, N).to(dtype))


def kernel_cases(torch, F, ops, ref):
    """(kernel, shape label, kernel fn, plain fn, library fn, bytes, flops,
    peak) at the serving paths' shapes."""
    from repro_torch.models.mamba2 import ssd_chunked
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    cases = []
    for rows, D in ((1024, 5120), (4, 5120), (40960, 128),
                    (1000, 1024), (1000, 2048), (4, 2048)):
        x, w = randn(rows, D), randn(D)
        cases.append((
            "rmsnorm", f"x[{rows},{D}]",
            lambda x=x, w=w: ops.rmsnorm(x, w, eps=1e-6),
            lambda x=x, w=w: ref.rmsnorm_ref(x, w, eps=1e-6),
            lambda x=x, w=w, D=D: F.rms_norm(x, (D,), w, 1e-6),
            2 * (2 * rows * D + D), 4 * rows * D, F32_FLOPS))
    for S in (1024, 1000):
        q, k, v = randn(1, S, 40, 128), randn(1, S, 8, 128), randn(1, S, 8, 128)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2                       # causal (q, k) pairs
        cases.append((
            "flash_attention", f"q[1,{S},40,128] kv[1,{S},8,128] causal",
            lambda q=q, k=k, v=v: ops.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v, causal=True),
            lambda q=qt, k=kt, v=vt: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            2 * (2 * q.numel() + 2 * k.numel()), 4 * 40 * 128 * pairs,
            BF16_TC_FLOPS))
    B, S, H, KH, Dh = 4, 2048, 40, 8, 128
    lens_list = [1, 517, 1024, 2048]
    q, kc, vc = randn(B, H, Dh), randn(B, S, KH, Dh), randn(B, S, KH, Dh)
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]                        # [B, 1, 1, S]
    qt, kt, vt = q[:, :, None, :], kc.transpose(1, 2).contiguous(), \
        vc.transpose(1, 2).contiguous()
    cases.append((
        "decode_attention", f"q[{B},{H},{Dh}] cache[{B},{S},{KH},{Dh}] "
                            f"lens={lens_list}",
        lambda: ops.decode_attention(q, kc, vc, lens),
        lambda: ref.decode_attention_ref(q, kc, vc, lens),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True),
        2 * (2 * q.numel() + 2 * KH * Dh * sum(lens_list)) + 4 * B,
        4 * H * Dh * sum(lens_list), BF16_TC_FLOPS))
    # mamba2-370m's SSD: H 32, head_dim 64, state 128, one prompt per prefill
    H, P, N = 32, 64, 128
    for L in (1024, 1000):
        x, dt, A, Bm, Cm = ssd_inputs(torch, F, gen, 1, L, H, P, N,
                                      torch.bfloat16)
        cases.append((
            "ssd_scan", f"x[1,{L},{H},{P}] B/C[1,{L},1,{N}]",
            lambda a=(x, dt, A, Bm, Cm): ops.ssd_scan(*a),
            lambda a=(x, dt, A, Bm, Cm): ref.ssd_scan_ref(*a),
            # yardstick: the port's plain chunked SSD at the model's chunk
            lambda a=(x, dt, A, Bm, Cm): ssd_chunked(*a, chunk=256),
            # x and y bf16, dt f32, A, B and C bf16, final state f32;
            # the recurrence's least work: S update and C·S, 4 N P a step
            2 * 2 * L * H * P + 4 * L * H + 4 * H + 2 * 2 * L * N
            + 4 * H * N * P, 4 * L * H * N * P, TF32_TC_FLOPS))
    return cases


SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:39"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:108"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:117"),
}
# the shape whose times stand for each kernel in the result line
MAIN_SHAPE = {"rmsnorm": "x[1024,5120]",
              "flash_attention": "q[1,1024,40,128] kv[1,1024,8,128] causal",
              "ssd_scan": "x[1,1024,32,64] B/C[1,1024,1,128]"}
# no single PyTorch call computes these: library_ms is null, and the
# named plain function is timed beside it as a yardstick
YARDSTICK = {"ssd_scan": "repro_torch.models.mamba2.ssd_chunked (plain PyTorch, chunk 256)"}


def check_kernels(torch, F, ops, ref) -> list:
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, shape, kern, plain, lib, nbytes, flops, peak in \
            kernel_cases(torch, F, ops, ref):
        errs = hold(name, kern(), plain(), f"kernel {name} {shape}")
        lib_ms = cuda_ms(torch, lib, flush)
        row = {"name": name, "shape": shape,
               "max_abs_err": max(e[0] for e in errs.values()),
               "max_row_rel_err": max(e[1] for e in errs.values()),
               "ms": cuda_ms(torch, kern, flush),
               "plain_ms": cuda_ms(torch, plain, flush),
               "library_ms": None if name in YARDSTICK else lib_ms}
        if name in OUTPUTS:
            row["errors"] = errs
        if name in YARDSTICK:
            row["yardstick"] = YARDSTICK[name]
            row["yardstick_ms"] = lib_ms
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, peak)
        print(f"kernel {name} {shape}: ms {row['ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} "
              + (f"yardstick_ms {lib_ms:.4f} ({YARDSTICK[name]}) "
                 if name in YARDSTICK else f"library_ms {lib_ms:.4f} ")
              + f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})",
              flush=True)
        rows.append(row)
    return rows


def check_edges(torch, F, ops, ref) -> dict:
    """Cases the serving shapes do not reach, for correctness only: decode
    rows with lens 0 (zeros, as the Pallas kernel) and lens past S
    (clamped), non-causal flash with Sq != Sk on both kernel paths,
    rmsnorm widths of other dispatch branches, and SSD scans of one
    position, of a ragged tile, of a batch of two, of an odd number of
    heads and of the f32 smoke widths."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, kc, vc = randn(4, 40, 128), randn(4, 256, 8, 128), randn(4, 256, 8, 128)
    lens = torch.tensor([0, 3, 256, 5000], dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens.clamp(max=256))
    require(bool((got[0] == 0).all()), "decode_attention: lens 0 is not zeros")
    pairs = {"decode lens 0/3/256/5000":
             ("decode_attention", got[1:], want[1:])}
    for dh, dtype in ((128, torch.bfloat16), (64, torch.bfloat16),
                      (128, torch.float32)):
        q = randn(2, 100, 8, dh, dtype=dtype)
        k, v = randn(2, 300, 2, dh, dtype=dtype), randn(2, 300, 2, dh, dtype=dtype)
        pairs[f"flash non-causal Sq 100 Sk 300 Dh {dh} {dtype}"] = (
            "flash_attention", ops.flash_attention(q, k, v, causal=False),
            ref.flash_attention_ref(q, k, v, causal=False))
    for shape, dtype in (((33, 5120), torch.float32), ((7, 3072), torch.bfloat16),
                         ((5, 40, 64), torch.float32)):
        x, w = randn(*shape, dtype=dtype), randn(shape[-1], dtype=dtype)
        pairs[f"rmsnorm {list(shape)} {dtype}"] = (
            "rmsnorm", ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    for B, L, H, P, N, dtype in ((1, 1, 32, 64, 128, torch.bfloat16),
                                 (1, 7, 32, 64, 128, torch.bfloat16),
                                 (1, 517, 32, 64, 128, torch.bfloat16),
                                 (2, 300, 32, 64, 128, torch.bfloat16),
                                 (1, 200, 5, 64, 128, torch.bfloat16),
                                 (2, 40, 16, 8, 16, torch.float32)):
        a = ssd_inputs(torch, F, gen, B, L, H, P, N, dtype)
        pairs[f"ssd_scan B {B} L {L} H {H} P {P} N {N} {dtype}"] = (
            "ssd_scan", ops.ssd_scan(*a), ref.ssd_scan_ref(*a))
    return {case: hold(name, got, want, f"edge {case}")
            for case, (name, got, want) in pairs.items()}


# Planted faults in csrc/ssd_scan.cu: (source text, its broken replacement)
PLANTED = {
    "carried state dropped": ("intra[r][k] + decay * inter[r][k]",
                              "intra[r][k]"),
    "diagonal excluded (i > j)": ("j <= i ?", "j < i ?"),
    "dt = 0 tail mask skipped": (
        "pos < L ? dt[(static_cast<size_t>(b) * L + pos) * H + h] : 0.f",
        "dt[(static_cast<size_t>(b) * L + min(pos, L - 1)) * H + h]"),
}


def check_planted(torch, F, ops, ref) -> dict:
    """Build a broken copy of the ssd_scan kernel for each PLANTED fault
    (nvcc, all at once, into kernels/build/planted/) and hold each, and
    the right kernel, against the plain version on one input that reaches
    all three faults: several tiles and a ragged last one (L = 517).  The
    right kernel must meet both limits and every broken one fail one."""
    from repro_torch.kernels import _build
    csrc = _build.CSRC
    dirs = []
    for i, (old, new) in enumerate(PLANTED.values()):
        d = _build.BUILD_DIR / "planted" / f"fault{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        shutil.copy(csrc / "common.cuh", d)
        text = (csrc / "ssd_scan.cu").read_text()
        require(text.count(old) == 1, f"planted fault text {old!r} not unique")
        (d / "ssd_scan.cu").write_text(text.replace(old, new))
        dirs.append(d)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = [_build.load(p) for p in pool.map(_build.build, dirs)]
    print(f"planted: built {len(libs)} broken copies in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(2)
    a = ssd_inputs(torch, F, gen, 1, 517, 32, 64, 128, torch.bfloat16)
    want = ref.ssd_scan_ref(*a)
    right = _build.library()
    out = {}
    for fault, lib in [("none (the right kernel)", right)] + \
            list(zip(PLANTED, libs)):
        _build._lib = lib
        try:
            got = ops.ssd_scan(*a)
            torch.cuda.synchronize()
        finally:
            _build._lib = right
        res = {}
        for part, g, w in zip(OUTPUTS["ssd_scan"], got, want):
            max_abs, max_row = errors(g, w)
            res[part] = {"max_abs_err": max_abs, "max_row_rel_err": max_row,
                         "within": within(g, w, f"ssd_scan.{part}")}
        passes = all(r["within"] for r in res.values())
        print(f"planted: {fault}: " + ", ".join(
            f"{p} max_row_rel_err {r['max_row_rel_err']:.3e} "
            f"{'passes' if r['within'] else 'FAILS'}" for p, r in res.items()),
            flush=True)
        require(passes == (lib is right),
                f"planted fault {fault!r}: the limits "
                + ("fail the right kernel" if lib is right else "let it pass"))
        out[fault] = res
    return out


def check_small(torch, arch: str) -> dict:
    """The port on the card against the port on the CPU, small and in f32."""
    import copy
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype="float32", activation_dtype="float32")
    run = RunConfig(attention_impl="pallas")
    on_cpu = models.init(0, cfg, device="cpu")
    on_card = copy.deepcopy(on_cpu).to(DEVICE)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen)
    want, _ = models.forward(on_cpu, {"tokens": toks}, cfg, run)
    got, _ = models.forward(on_card, {"tokens": toks.to(DEVICE)}, cfg, run)
    err = float((got.cpu() - want).abs().max())
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=gen).tolist()
               for n in (5, 19, 37)]

    def greedy(params, device):
        eng = ServeEngine(cfg, run, params, n_slots=2, max_seq=64,
                          device=device)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new_tokens=6)
        return {r.request_id: r.generated for r in eng.run_until_idle()}

    same = greedy(on_card, DEVICE) == greedy(on_cpu, "cpu")
    print(f"small: {arch} f32 forward logits card vs cpu max_abs_err "
          f"{err:.3e} (tol {SMALL_TOL}); greedy tokens equal {same}",
          flush=True)
    require(err <= SMALL_TOL and same, f"{arch}: the card disagrees with the CPU")
    return {"logits_max_abs_err": err, "greedy_equal": same}


def profile_step(torch, what: str, step, n: int = 5) -> dict:
    """Where one step's time goes: step() (which ends in a sync) timed on
    the host without the profiler, then traced with torch.profiler for its
    device time by kernel; busy share = device time / host time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    kernels = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / n / 1e3, e.count / n, e.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    out = {"step_host_ms": host_ms,
           "step_device_ms": device_ms if kernels else None,
           "device_busy_share": device_ms / host_ms if kernels else None,
           "launches_per_step": sum(k[1] for k in kernels),
           "top": [{"kernel": k[2][:90], "ms": k[0], "count": k[1]}
                   for k in kernels[:10]]}
    print(f"trace: {what} " + json.dumps(out), flush=True)
    return out


def trace_decode(torch, eng, cfg, run) -> dict:
    """One lockstep decode step over all slots (positions
    1000/700/500/300)."""
    from repro_torch import models
    batch = {"tokens": torch.zeros((N_SLOTS, 1), dtype=torch.int32,
                                   device=DEVICE),
             "seq_lens": torch.tensor([1000, 700, 500, 300][:N_SLOTS],
                                      dtype=torch.int32, device=DEVICE),
             "active": torch.ones(N_SLOTS, dtype=torch.bool, device=DEVICE)}

    def step():
        logits, _ = models.decode_step(eng.params, eng.cache, batch, cfg, run)
        return logits.argmax(dim=-1).cpu()

    return profile_step(torch, "decode step", step)


def trace_prefill(torch, eng, cfg, run, prompt: list) -> dict:
    """One 1024-token prefill into slot 0 of the engine's cache (a whole
    prefill bucket for the dense family, an exact length for ssm)."""
    from repro_torch.models import transformer as T
    batch = {"tokens": torch.tensor([prompt], device=DEVICE),
             "last_index": torch.tensor([len(prompt) - 1], device=DEVICE)}

    def step():
        logits, _ = T.prefill_with_cache(eng.params, batch, cfg, run, MAX_SEQ,
                                         cache=eng.cache, slot=0)
        return logits.argmax(dim=-1).cpu()

    return profile_step(torch, f"prefill of {len(prompt)} tokens", step, n=3)


def path_launches(cfg) -> tuple[dict, dict]:
    """Kernel launches per prefill and per decode step on a family's path."""
    L = cfg.n_layers
    if cfg.family == "ssm":      # ln + gate norm per layer, final norm
        return ({"rmsnorm": 2 * L + 1, "ssd_scan": L},
                {"rmsnorm": 2 * L + 1})
    # dense: ln1, ln2, q-norm, k-norm per layer, final norm
    return ({"rmsnorm": 4 * L + 1, "flash_attention": L},
            {"rmsnorm": 4 * L + 1, "decode_attention": L})


def serve(torch, arch: str) -> dict:
    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    run = RunConfig(attention_impl="pallas")
    t0 = time.perf_counter()
    params = models.init(0, cfg, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve: {arch} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"params {n_params} init_s {time.perf_counter() - t0:.3f}",
          flush=True)
    eng = ServeEngine(cfg, run, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                      device=DEVICE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQ)]
    # warm-up request (cuBLAS handles and workspaces), not measured
    eng.submit("warmup", prompts[-1][:100], max_new_tokens=2)
    eng.run_until_idle()
    for k in eng.metrics:
        eng.metrics[k] = type(eng.metrics[k])(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                        # counts to 0, then the path
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(f"req{i}", p, max_new_tokens=NEW_TOKENS)
    eng.tick()                                  # admits and prefills req0
    logits0 = eng.last_prefill_logits.clone()
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)               # read just after

    m = eng.metrics
    require(len(done) == N_REQ, f"{len(done)} of {N_REQ} requests finished")
    for r in done:
        require(len(r.generated) == NEW_TOKENS,
                f"{r.request_id} got {len(r.generated)} tokens")
    per_prefill, per_step = path_launches(cfg)
    want = {k: m["prefills"] * per_prefill.get(k, 0)
            + m["decode_steps"] * per_step.get(k, 0) for k in launches}
    on_path = set(per_prefill) | set(per_step)
    require(all(want[k] for k in on_path) and launches == want,
            f"launches {launches}, the path needs {want}")
    require(eng.slots.n_free == N_SLOTS, "slots were not all returned")

    ttft = sorted(r.first_token_at - r.arrived for r in done)
    # one request's prefill logits against the port's own forward pass
    fwd, _ = models.forward(params, {"tokens": torch.tensor(
        [prompts[0]], device=DEVICE)}, cfg, run, last_only=True)
    ref_logits = fwd[0, -1]
    require(logits0.shape == (cfg.vocab,) and bool(torch.isfinite(logits0).all()),
            "prefill logits are not finite or of the wrong shape")
    diff = float((logits0 - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    agree = int(logits0.argmax()) == int(ref_logits.argmax())
    print(f"serve: {arch} prefill vs forward logits max|diff| {diff:.4e} "
          f"max|logit| {scale:.4e} rel {diff / scale:.4e} "
          f"(tol {LOGITS_REL_TOL}) argmax agree {agree}", flush=True)
    require(diff <= LOGITS_REL_TOL * scale, "prefill logits disagree with forward")

    res = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "requests": len(done), "new_tokens": NEW_TOKENS,
           "prompt_lens": [len(p) for p in prompts], "wall_s": wall,
           "ttft_p50_s": statistics.median(ttft), "ttft_s": ttft,
           "prefill_mean_s": m["prefill_s"] / m["prefills"],
           "decode_steps": m["decode_steps"],
           "decode_step_mean_s": m["decode_s"] / m["decode_steps"],
           "decode_tokens_per_s": m["tokens_generated"] / m["decode_s"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "launches_per_prefill": per_prefill,
           "launches_per_decode_step": per_step,
           "logits_rel_diff": diff / scale,
           "decode_trace": trace_decode(torch, eng, cfg, run),
           "prefill_trace": trace_prefill(
               torch, eng, cfg, run,
               rng.integers(0, cfg.vocab, 1024).tolist())}
    print("serve: " + json.dumps(res), flush=True)
    del eng, params, fwd, logits0, ref_logits    # the next phase starts empty
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds} s)", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas: " + line.strip(), flush=True)

    rows = check_kernels(torch, F, ops, ref)
    edges = check_edges(torch, F, ops, ref)
    planted = check_planted(torch, F, ops, ref)
    small = {arch: check_small(torch, arch) for arch in SERVED}
    served = {}
    for arch in SERVED:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"serve: {arch} starts with {torch.cuda.memory_allocated()} "
              f"bytes allocated", flush=True)
        served[arch] = serve(torch, arch)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        main_row = next((r for r in mine if r["shape"] == MAIN_SHAPE.get(name)),
                        mine[0])
        by_path = {arch: res["launches"][name] for arch, res in served.items()
                   if res["launches"][name]}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"]}
        if name in YARDSTICK:
            entry["yardstick"] = YARDSTICK[name]
            entry["yardstick_ms"] = main_row["yardstick_ms"]
        kernels.append(entry)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernel_cases": rows, "edges": edges,
             "planted": planted, "small": small, "serve": served,
             "kernels": kernels}, indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
