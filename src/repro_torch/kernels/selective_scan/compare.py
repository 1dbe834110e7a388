"""Time this checkout's selective-scan kernel against other builds of
``selective_scan.cu`` on one card, in one process and in alternating
rounds, and read the built step loop's instructions.

    git show <rev>:src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu > _checkout/old.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.selective_scan.compare _checkout/old.cu [...] [--variants] [--probe] [--sass]

(``_checkout/`` is gitignored.)  Every build runs bf16 at jamba's
prefill shape (B 2, S 32,768, d_inner 16,384, N 16; B and C column
slices of one x_proj output, dt from Mamba's init) on the same inputs
and must keep this entry point's signature.  ``--variants`` adds copies
of this checkout's source with one line changed (``VARIANTS``), built
under ``_checkout/``.  Each build's raw entry point is called on the
same outputs, so no build pays the wrapper's host time.  Prints the card, each build's largest row
error of y against the plain version (``ref.py``) and the count of final
state elements that differ from the plain loop's, each build's
registers and spill bytes by kernel instance (``-Xptxas -v``), the
median ms of each build over rounds that alternate their order, and the
SM clock and power read while they ran.  The backward (``--bwd``, below)
runs through the same harness.

``--probe`` adds the diagnostic copies of ``PROBES`` to the rounds and
runs the rate probes of ``PROBE_SOURCE``: what the arithmetic alone
allows.  ``--sass`` reads each build's ``cuobjdump -sass``: in each
instance of the kernel, of the innermost loops that hold ``MUFU.EX2``
(one a state update, so their count is the loop's elements) the one
with the most is the step loop; its instructions an element by class,
those of the tile loop around it spread over a tile's elements (``TILE
* N`` a thread; counted as written, the ragged tile's code included), and the issue floor they give at one warp instruction a clock
on each of an SM's 4 schedulers (132 SMs, 1.98 GHz, the clock of
``chip_smoke.py``'s peaks).

``--bwd`` times the backward instead, the same way: this checkout's
``selective_scan_bwd`` entry (the kernel and its ordered sums) against
the other builds' at jamba's training shape (B 2, S 4,096, d_inner
16,384, N 16, bf16), each build's dx, ddt, dA, dB and dC held against
``ref.selective_scan_bwd_ref`` on the same inputs.  With ``--probe``
the diagnostic copies of ``BWD_PROBES`` join the rounds, made from each
given source in which all of a probe's anchors stand once; with
``--variants``, the copies of ``BWD_VARIANTS`` of this checkout's
source.  With ``--sass``, every loop of each build's backward kernels:
its instructions by class and its ``MUFU.EX2`` count, and this design's
issue floor (``bwd_issue_floor``), the full listing written to
``_checkout/selective_scan_bwd_<build>.sass``.

    git show <rev>:src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu > _checkout/old.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.selective_scan.compare --bwd _checkout/old.cu --probe --variants --sass
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import nvcc
from . import build, ops, ref

ROOT = Path(__file__).resolve().parents[4]
ROUNDS, REPS = 6, 5
#: jamba's prefill: batch, steps, d_inner, states
SHAPE = (2, 32_768, 16_384, 16)
#: copies of this checkout's source, each a list of (anchor, replacement)
#: pairs; ``unaligned`` launches the instance that reads each row's offset
#: at jamba's aligned rows too
VARIANTS = {
    "unaligned": [("return aligned ? launch_instance<T, 16, 1>",
                   "return false ? launch_instance<T, 16, 1>")],
    "channels32": [("constexpr int CHANNELS = 64;",
                    "constexpr int CHANNELS = 32;")],
    "tile16": [("constexpr int TILE = 32;", "constexpr int TILE = 16;")],
    "tile64": [("constexpr int TILE = 32;", "constexpr int TILE = 64;")],
    "unroll2": [("#pragma unroll 4\n", "#pragma unroll 2\n")],
    "unroll8": [("#pragma unroll 4\n", "#pragma unroll 8\n")],
}
#: diagnostic copies, timed but not meant to be right: ``noload`` copies
#: the first tile only and scans whatever the ring holds after it (the
#: scan's arithmetic and stores without the loads)
PROBES = {
    "noload": [("    if (k + 1 < tiles) issue(k + 1);\n", "")],
}
SMS, CLOCK_HZ, SCHEDULERS = 132, 1.98e9, 4

#: jamba's training microbatch for ``--bwd``: batch, steps, d_inner, states
BWD_SHAPE = (2, 4_096, 16_384, 16)
#: diagnostic copies of a backward source (``--bwd --probe``), timed but not
#: meant to be right, each a list of (anchor, replacement) pairs, made from
#: every given source in which all its anchors stand once.  Of this design:
#: ``phase1_alone`` skips phase 2, ``no_back`` the walk, ``no_reduce`` the
#: cluster's sums of dB and dC, ``no_cluster`` the cluster's barrier a tile
#: and all but tile 0's sums, ``sums_alone`` launches only the ordered sums.
BWD_PROBES = {
    "phase1_alone": [("  for (int k = tiles - 1; k >= 0; --k) {\n",
                      "  for (int k = tiles - 1; k >= tiles; --k) {\n")],
    "no_back": [("        for (int j = SUB - 1; j >= 0; --j) back(j);\n",
                 "        for (int j = SUB - 1; j >= SUB; --j) back(j);\n"),
                ("        for (int j = n_s - 1; j >= 0; --j) back(j);\n",
                 "        for (int j = n_s - 1; j >= n_s; --j) back(j);\n")],
    "no_reduce": [("      reduce(k + 1);\n", ""), ("  reduce(0);\n", "")],
    "no_cluster": [("      cluster_wait();\n      reduce(k + 1);\n", ""),
                   ("    cluster_arrive();                   // tile k walked\n",
                    "")],
    "sums_alone": [("  int rc = aligned ? launch_bwd_instance<T, 1>(p, stream)\n"
                    "                   : launch_bwd_instance<T, 0>(p, stream);",
                    "  int rc = aligned ? 0 : 0;")],
}
#: copies of this checkout's backward with its constants changed (``--bwd
#: --variants``): the state saved every 4, 16 or 32 steps (``tile4``: no
#: start replayed, 2 exponential passes, twice the scratch; ``tile16``,
#: ``tile32_sub8``: the first design's density, 2.75 passes), sub-tiles of 8 steps
#: (``sub8``: 2 passes, a larger block), the cluster's wait at the top of a
#: tile (not after the replay of its sub-tile starts), clusters of 4 and 8,
#: blocks of 32 channels in clusters of 4 and of 64 in clusters of 4 (8 and
#: 4 blocks an SM) and of 256 alone (one an SM; all but ``cluster4`` and
#: ``cluster8`` with the same channels a partial), and the walk's steps
#: not unrolled
BWD_VARIANTS = {
    "tile4": [("constexpr int BWD_TILE = 8;", "constexpr int BWD_TILE = 4;")],
    "tile16": [("constexpr int BWD_TILE = 8;",
                "constexpr int BWD_TILE = 16;")],
    "tile32_sub8": [("constexpr int BWD_TILE = 8;",
                     "constexpr int BWD_TILE = 32;"),
                    ("constexpr int SUB = 4;", "constexpr int SUB = 8;")],
    "sub8": [("constexpr int SUB = 4;", "constexpr int SUB = 8;")],
    "wait_at_top": [("      cluster_wait();\n      reduce(k + 1);\n", ""),
                    ("    lane_st(Lay::STARTS, saved);        // sub-tile 0's "
                     "start\n",
                     "    lane_st(Lay::STARTS, saved);\n"
                     "    if (k + 1 < tiles) { cluster_wait(); "
                     "reduce(k + 1); }\n")],
    "cluster4": [("constexpr int BWD_CLUSTER = 2;",
                  "constexpr int BWD_CLUSTER = 4;")],
    "cluster8": [("constexpr int BWD_CLUSTER = 2;",
                  "constexpr int BWD_CLUSTER = 8;")],
    "block32_cluster4": [("constexpr int BWD_CHANNELS = 128;",
                          "constexpr int BWD_CHANNELS = 32;"),
                         ("constexpr int BWD_CLUSTER = 2;",
                          "constexpr int BWD_CLUSTER = 4;"),
                         ("constexpr int BWD_MIN_BLOCKS = 2;",
                          "constexpr int BWD_MIN_BLOCKS = 8;")],
    "block64_cluster4": [("constexpr int BWD_CHANNELS = 128;",
                          "constexpr int BWD_CHANNELS = 64;"),
                         ("constexpr int BWD_CLUSTER = 2;",
                          "constexpr int BWD_CLUSTER = 4;"),
                         ("constexpr int BWD_MIN_BLOCKS = 2;",
                          "constexpr int BWD_MIN_BLOCKS = 4;")],
    "block256_alone": [("constexpr int BWD_CHANNELS = 128;",
                        "constexpr int BWD_CHANNELS = 256;"),
                       ("constexpr int BWD_CLUSTER = 2;",
                        "constexpr int BWD_CLUSTER = 1;"),
                       ("constexpr int BWD_MIN_BLOCKS = 2;",
                        "constexpr int BWD_MIN_BLOCKS = 1;")],
    "walk_unroll1": [("#pragma unroll\n"
                      "        for (int j = SUB - 1; j >= 0; --j) back(j);",
                      "#pragma unroll 1\n"
                      "        for (int j = SUB - 1; j >= 0; --j) back(j);")],
}

#: rate probes (``--probe``), no memory traffic in their loops: MUFU.EX2
#: alone (8 independent chains a thread, 8 warps a scheduler), and the
#: scan's element as the kernel computes it (16 states a thread, dt and
#: x new each step, the rounded exp, the unfused update, y in two
#: partial sums; blocks of 64 threads, 4 an SM, as the kernel runs)
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) ex2_probe(float* out, int iters) {
  float v[8];
  for (int k = 0; k < 8; ++k) v[k] = 1e-3f * (threadIdx.x + k);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(v[k]));
  }
  float acc = 0.f;
  for (int k = 0; k < 8; ++k) acc += v[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
__global__ void __launch_bounds__(64, 4) element_probe(float* out, int iters) {
  float a[16], b[16], c[16], h[16];
  for (int k = 0; k < 16; ++k) {
    a[k] = -(k + 1.f); b[k] = 0.01f * k * (threadIdx.x & 7);
    c[k] = 1.f - 0.03f * k; h[k] = 0.f;
  }
  float dt = 1e-3f * (1 + (threadIdx.x & 31)), xv = 0.5f, y = 0.f;
  for (int i = 0; i < iters; ++i) {
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float dA = expf(__fmul_rn(dt, a[k]));
      const float dBx = __fmul_rn(__fmul_rn(dt, b[k]), xv);
      h[k] = __fadd_rn(__fmul_rn(dA, h[k]), dBx);
      if (k < 8) p0 = fmaf(h[k], c[k], p0); else p1 = fmaf(h[k], c[k], p1);
    }
    y += p0 + p1;
    dt += 1e-7f;
    xv -= 1e-6f;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = y;
}
extern "C" int run_probe(int kind, float* out, int sms, int iters) {
  if (kind == 0) ex2_probe<<<sms * 8, 256>>>(out, iters);
  else element_probe<<<sms * 4, 64>>>(out, iters);
  return cudaGetLastError();
}
"""
#: each probe's name, threads a launch (times the SMs) and operations a
#: thread and iteration
PROBE_KINDS = (("ex2_alone", 8 * 256, 8), ("scan_element", 4 * 64, 16))

_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSET", "FSETP", "FSWZADD",
         "FRND"}
_INT = {"IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "MOV",
        "IABS", "IMNMX", "POPC", "FLO", "BMSK", "PLOP3", "P2R", "R2P", "IADD",
        "I2F", "F2I", "I2FP", "F2FP", "VIADD", "VIMNMX"}


def _class(op: str) -> str:
    base = op.split(".")[0]
    if base in _FP32:
        return "fp32"
    if base == "MUFU":
        return "mufu"
    if base in _INT:
        return "int"
    if base.startswith("U"):
        return "uniform"
    if base in ("LDS", "LDSM"):
        return "shared_load"
    if base == "STS":
        return "shared_store"
    return "other"


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str]]]:
    """``parse_sass`` of ``cuobjdump -sass lib``."""
    tool = Path(nvcc.nvcc()).with_name("cuobjdump")
    return parse_sass(subprocess.run([str(tool), "-sass", str(lib)],
                                     check=True, capture_output=True,
                                     text=True).stdout)


def parse_sass(text: str) -> dict[str, list[tuple[int, str]]]:
    """Each function of a ``cuobjdump -sass`` listing: its instructions
    as (address, text without the predicate), branch labels resolved to
    addresses."""
    funcs, name, labels, pending = {}, None, {}, []
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, re.sub(r"^@!?U?P\w+\s+", "",
                                             m.group(2))))
    out = {}
    for name, ins in funcs.items():
        resolved = []
        for addr, txt in ins:
            lab = re.search(r"`?\((\.L_x_\d+)\)", txt)
            if lab and lab.group(1) in labels[name]:
                txt = f"{txt.split()[0]} 0x{labels[name][lab.group(1)]:x}"
            resolved.append((addr, txt))
        out[name] = resolved
    return out


def _loops(ins):
    """(start, end) address spans of the backward branches."""
    spans = []
    for addr, txt in ins:
        m = re.match(r"BRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)", txt)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    return spans


def _count(ins, lo, hi, skip=()):
    counts = {}
    for addr, txt in ins:
        if lo <= addr <= hi and not any(a <= addr <= b for a, b in skip):
            op = txt.split()[0]
            if op != "NOP":
                k = _class(op)
                counts[k] = counts.get(k, 0) + 1
    return counts


def step_loop_report(ins, tile: int, per_thread: int) -> dict:
    """The step loop (see the module note) and the tile loop around it: their
    instructions an element by class and the issue floor at jamba's
    shape."""
    spans = _loops(ins)
    mufu = {s: _count(ins, *s).get("mufu", 0) for s in spans}

    def inside(s, t):
        return t[0] <= s[0] and s[1] <= t[1] and s != t

    # the innermost loops that hold exponentials; the step loop is the one
    # with the most of them
    inner_most = [s for s in spans if mufu[s] and not any(
        mufu[t] and inside(t, s) for t in spans)]
    if not inner_most:
        return {"error": "no loop with MUFU"}
    top = max(mufu[s] for s in inner_most)
    inner = min((s for s in inner_most if mufu[s] == top),
                key=lambda s: s[1] - s[0])
    outer = [s for s in spans if inside(inner, s)]
    step = _count(ins, *inner)
    rep = {"step_loop": f"0x{inner[0]:x}-0x{inner[1]:x}",
           "elements_an_iteration": top,
           "step_per_element": {k: v / top for k, v in step.items()}}
    total = sum(step.values()) / top
    if outer:
        tl = min(outer, key=lambda s: s[1] - s[0])
        # every MUFU-bearing loop inside the tile loop is a step loop (the
        # full tiles' and the ragged last tile's): the rest is the tile's
        rest = _count(ins, *tl, skip=[s for s in spans
                                      if mufu[s] and inside(s, tl)])
        rep["tile_loop"] = f"0x{tl[0]:x}-0x{tl[1]:x}"
        rep["tile_per_element"] = {k: v / (tile * per_thread)
                                   for k, v in rest.items()}
        total += sum(rest.values()) / (tile * per_thread)
    B, S, D, N = SHAPE
    rep["instructions_an_element"] = total
    rep["fp32_an_element"] = step.get("fp32", 0) / top
    rep["issue_floor_ms"] = (B * S * D * N * total
                             / (32 * SCHEDULERS * SMS * CLOCK_HZ) * 1e3)
    rep["fp32_floor_ms"] = (B * S * D * N * rep["fp32_an_element"]
                            / (32 * SCHEDULERS * SMS * CLOCK_HZ) * 1e3)
    return rep


def _tile(src: Path) -> int:
    return int(re.search(r"constexpr int TILE = (\d+);",
                         src.read_text()).group(1))


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs timed with
    CUDA events, after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _build(src: Path) -> Path:
    """``src`` built beside it, its ``-Xptxas -v`` report as ``.log``."""
    lib = src.with_suffix(".so")
    proc = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib),
                           str(src)], check=True, capture_output=True,
                          text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return lib


def rate_probes(scratch: Path) -> dict:
    """Operations per SM and clock (132 SMs, 1.98 GHz) of each probe, and
    the ms its rate gives jamba's B * S * D * N elements: what the
    arithmetic alone allows the kernel."""
    src = scratch / "selective_scan_probe.cu"
    src.write_text(PROBE_SOURCE)
    lib = ctypes.CDLL(str(_build(src)))
    lib.run_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int]
    iters = 4096
    out = torch.empty(SMS * 8 * 256, device="cuda")
    B, S, D, N = SHAPE
    rates = {}
    for kind, (name, threads, per) in enumerate(PROBE_KINDS):
        def run(kind=kind, name=name):
            if lib.run_probe(kind, out.data_ptr(), SMS, iters):
                raise RuntimeError(f"probe {name} failed to launch")
        ms = cuda_ms(run, 5)
        rate = SMS * threads * iters * per / (ms * 1e-3) / (SMS * CLOCK_HZ)
        rates[name] = {"ms": ms, "per_sm_clock": rate,
                       "jamba_ms": B * S * D * N / (rate * SMS * CLOCK_HZ)
                       * 1e3}
    return rates


def loop_table(ins) -> list[dict]:
    """Every loop (backward branch) of a function, outermost first: its
    address span, its instructions by class (its inner loops' included),
    its ``MUFU.EX2`` count and whether it holds another loop."""
    spans = sorted(_loops(ins), key=lambda s: (s[0], -s[1]))
    out = []
    for lo, hi in spans:
        counts = _count(ins, lo, hi)
        mufu_ex2 = sum(1 for a, t in ins if lo <= a <= hi
                       and t.startswith("MUFU.EX2"))
        out.append({"span": f"0x{lo:x}-0x{hi:x}",
                    "instructions": sum(counts.values()), "by_class": counts,
                    "mufu_ex2": mufu_ex2,
                    "innermost": not any(lo <= a and b <= hi and
                                         (a, b) != (lo, hi)
                                         for a, b in spans)})
    return out


def bwd_issue_floor(ins, half: int, tile: int, sub: int) -> dict:
    """This design's instructions an element (a state and step) from its
    built loops, and the issue floor they give at jamba's training shape
    (one warp instruction a clock on each of an SM's 4 schedulers): phase
    1's tile loop (the first loop with exponentials, ``half * tile``
    elements an iteration); in phase 2's tile loop (the largest loop that
    holds others) the replay of the sub-tile starts (its inner loop of
    ``half * sub`` exponentials, run ``tile / sub - 1`` times a tile), the
    sub-tile loop (``half * sub`` elements a full sub-tile; the ragged last
    sub-tile's own loops left out) and the rest of the tile loop, once a
    tile."""
    spans = _loops(ins)

    def inside(s, t):
        return t[0] <= s[0] and s[1] <= t[1] and s != t

    def count(s):
        return sum(_count(ins, *s).values())

    def ex2(s):
        return _count(ins, *s).get("mufu", 0)

    phase1 = min((s for s in spans if ex2(s) and
                  not any(inside(t, s) for t in spans)), key=lambda s: s[0])
    phase2 = max((s for s in spans if any(inside(t, s) for t in spans)),
                 key=count)
    start = next(s for s in spans if inside(s, phase2) and
                 ex2(s) == half * sub and not any(inside(t, s) for t in spans))
    subtile = next(s for s in spans if inside(s, phase2) and ex2(s) and
                   any(inside(t, s) for t in spans))
    ragged = sum(count(t) for t in spans if inside(t, subtile))
    per = {"phase1": count(phase1) / (half * tile),
           "start_replay": count(start) / (half * sub) * (1 - sub / tile),
           "sub_tiles": (count(subtile) - ragged) / (half * sub),
           "tile_rest": (count(phase2) - count(start) - count(subtile))
           / (half * tile)}
    total = sum(per.values())
    B, S, D, N = BWD_SHAPE
    return {"instructions_an_element": total, "by_part": per,
            "issue_floor_ms": B * S * D * N * total
            / (32 * SCHEDULERS * SMS * CLOCK_HZ) * 1e3}


def ptxas(log: str, kernel: str) -> dict:
    """Registers and spill bytes (stores + loads) of each instance of
    ``kernel`` in a ``-Xptxas -v`` log, keyed by its mangled template
    arguments."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            name = (fn.split(kernel, 1)[1].split("EEv")[0]
                    if re.search(rf"\d{kernel}I", fn) else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(name, {})["spill_bytes"] = (int(m.group(1))
                                                      + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def _bwd_errors(got, want) -> dict:
    """Row errors of dx and ddt; dA, dB and dC's largest |difference|
    relative to their largest |value| (``chip_smoke.py``'s gate)."""
    out = {k: float(ref.row_errors(g, w).max())
           for k, g, w in zip(("dx_row", "ddt_row"), got, want)}
    out.update({k: float((g - w).abs().max() / w.abs().max())
                for k, g, w in zip(("dA", "dB", "dC"), got[2:], want[2:])})
    return out


def _while(run_rounds) -> dict:
    """``run_rounds()`` with the card's SM clock and power sampled every
    100 ms."""
    smi_log = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        run_rounds()
    finally:
        smi_log.terminate()
        samples = [[float(v) for v in ln.split(",")]
                   for ln in smi_log.communicate()[0].splitlines()
                   if ln.count(",") == 1]
    return {"sm_clock_mhz": sorted(c for c, _ in samples),
            "power_w": sorted(w for _, w in samples)}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _copies(texts: dict[str, str], table: dict, strict: bool
            ) -> dict[str, str]:
    """The text of each copy ``table`` names, as ``<source>:<copy>``: of
    each source in ``texts`` in which all the copy's anchors stand once,
    or where ``strict`` of every source, whose anchors must all stand."""
    out = {}
    for name, text in texts.items():
        for copy, pairs in table.items():
            if not all(text.count(old) == 1 for old, _ in pairs):
                if strict:
                    raise SystemExit(f"{copy}: an anchor is not once in "
                                     f"{name}'s source")
                continue
            changed = text
            for old, new in pairs:
                changed = changed.replace(old, new)
            out[f"{name}:{copy}"] = changed
    return out


def _builds(argv: list[str], variants: dict, probes: dict,
            probes_of_every_source: bool) -> tuple[dict, dict]:
    """This checkout's source, the sources ``argv`` names, and the copies
    that ``--variants`` (of this source) and ``--probe`` (of this source,
    or of every source in which their anchors stand) add, written under
    ``_checkout/``; each built, one ``nvcc`` a build, all at once.
    Returns (their sources, their libraries) by name."""
    scratch = ROOT / "_checkout"
    scratch.mkdir(exist_ok=True)
    sources = {"this": build.SOURCE,
               **{Path(a).stem: Path(a).resolve() for a in argv
                  if not a.startswith("--")}}
    texts = {name: src.read_text() for name, src in sources.items()}
    chosen = {}
    if "--probe" in argv:
        chosen.update(_copies(texts if probes_of_every_source else
                              {"this": texts["this"]}, probes,
                              strict=not probes_of_every_source))
    if "--variants" in argv:
        chosen.update(_copies({"this": texts["this"]}, variants, strict=True))
    for name, text in chosen.items():
        src = scratch / f"selective_scan_{name.replace(':', '_')}.cu"
        src.write_text(text)
        sources[name] = src
    libs = {"this": build.build()}
    others = [n for n in sources if n != "this"]
    with ThreadPoolExecutor(max(1, len(others))) as pool:   # nvcc at once
        libs.update(zip(others, pool.map(_build, (sources[n]
                                                  for n in others))))
    return sources, libs


def _entries(libs: dict, entry: str, argtypes: list) -> dict:
    """Each library's ``entry``, typed."""
    out = {}
    for name, lib in libs.items():
        fn = out[name] = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return out


def _launcher(fn, *args):
    """``fn(*args, stream)`` on the current stream, raising on an error."""
    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    return run


def _alternating(runs: dict, check) -> dict:
    """Each build's ``check(name)`` after one run of it (a build the card
    refuses leaves the rounds), then ``ROUNDS`` rounds that alternate the
    builds' order, each build timed over ``REPS`` runs a round: the
    card, the errors, each round's ms and their median by build, and the
    card's clock and power meanwhile."""
    errs = {}
    for name, run in list(runs.items()):
        try:
            run()
        except RuntimeError as e:
            errs[name] = {"refused": str(e)}
            del runs[name]
            continue
        torch.cuda.synchronize()
        errs[name] = check(name)
    times = {name: [] for name in runs}

    def rounds():
        for r in range(ROUNDS):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[name].append(cuda_ms(runs[name], REPS))

    while_timed = _while(rounds)
    return {"card": _card(), "errors": errs,
            "median_ms": {k: sorted(v)[ROUNDS // 2] for k, v in times.items()},
            "ms": times, "while_timed": while_timed}


def _bwd_scratch(lib: Path, B: int, S: int, D: int, N: int) -> list[int]:
    """The floats of a build's four backward scratch arrays: its
    ``selective_scan_bwd_scratch``'s, or for a source without one (the
    first design) that design's: a state every 32 steps, and a partial of
    dB and of dC every 64 channels."""
    cdll = ctypes.CDLL(str(lib))
    if hasattr(cdll, "selective_scan_bwd_scratch"):
        floats = (ctypes.c_longlong * 4)()
        build.typed(cdll).selective_scan_bwd_scratch(B, S, D, N, floats)
        return list(floats)
    parts = -(-D // 64) * B * S * N
    return [B * -(-S // 32) * D * N, parts, parts, B * D * N]


def bwd_main(argv: list[str]) -> None:
    """``--bwd``: see the module note."""
    _, libs = _builds(argv, BWD_VARIANTS, BWD_PROBES, True)
    fns = _entries(libs, "selective_scan_bwd", build.BWD_ARGTYPES)
    B, S, D, N = BWD_SHAPE
    x, dt, A, Bm, Cm = args = ref.scan_inputs(B, S, D, torch.bfloat16, 7)
    gy = torch.randn((B, S, D), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(9))

    def empty(n):
        return torch.empty(n, dtype=torch.float32, device="cuda")

    outs = (empty((B, S, D)), empty((B, S, D)), empty((D, N)),
            empty((B, S, N)), empty((B, S, N)))
    # one scratch array of each kind, as large as any build's
    sizes = [_bwd_scratch(lib, B, S, D, N) for lib in libs.values()]
    scr = [empty(max(s[i] for s in sizes)) for i in range(4)]
    runs = {name: _launcher(
        fn, *(t.data_ptr() for t in args), gy.data_ptr(), None,
        *(t.data_ptr() for t in outs), *(t.data_ptr() for t in scr), 1, B, S,
        D, N, *x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2],
        *Cm.stride()[:2]) for name, fn in fns.items()}
    want = ref.selective_scan_bwd_ref(*args, gy)

    def check(name):
        errs = _bwd_errors(outs, want)
        if name == "this":
            first = [t.clone() for t in outs]
            runs[name]()
            torch.cuda.synchronize()
            errs["unequal_between_runs"] = sum(
                int((a != b).sum()) for a, b in zip(first, outs))
        return errs

    out = {"shape": BWD_SHAPE, **_alternating(runs, check),
           "ptxas": {name: ptxas(lib.with_suffix(".log").read_text(),
                                 "selective_scan_bwd_kernel")
                     for name, lib in libs.items()},
           "forward_ms": cuda_ms(lambda: ops.selective_scan(*args), REPS)}
    del want
    lib = build.load()
    out["this_blocks_per_sm"] = {
        f"{'bf16' if bf else 'f32'}_{'aligned' if al else 'unaligned'}":
            lib.selective_scan_bwd_blocks_per_sm(bf, al)
        for bf in (1, 0) for al in (1, 0)}
    out["this_threads"] = lib.selective_scan_bwd_threads()
    if "--sass" in argv:             # the given builds, not the copies
        out["sass"] = {}
        for name in (n for n in libs if ":" not in n):
            funcs = {fn: ins for fn, ins in sass_functions(libs[name]).items()
                     if "selective_scan_bwd_kernel" in fn}
            (ROOT / "_checkout" / f"selective_scan_bwd_{name}.sass"
             ).write_text("".join(
                 f"{fn}\n" + "".join(f"  {a:06x} {txt}\n" for a, txt in ins)
                 for fn, ins in funcs.items()))
            out["sass"][name] = {fn: loop_table(ins)
                                 for fn, ins in funcs.items()
                                 if "bfloat16" in fn}
        out["this_issue_floor"] = {   # jamba's instance: rows aligned
            fn: bwd_issue_floor(ins, N // 2, ops.BWD_TILE_STEPS,
                                ops.BWD_SUB_STEPS)
            for fn, ins in sass_functions(libs["this"]).items()
            if "selective_scan_bwd_kernel" in fn and "bfloat16" in fn
            and "Li1EE" in fn}
    print(json.dumps(out))


def main(argv: list[str]) -> None:
    if "--bwd" in argv:
        bwd_main(argv)
        return
    sources, libs = _builds(argv, VARIANTS, PROBES, False)
    fns = _entries(libs, "selective_scan", build.SCAN_ARGTYPES)
    B, S, D, N = SHAPE
    x, dt, A, Bm, Cm = args = ref.scan_inputs(B, S, D, torch.bfloat16, 7)
    y = torch.empty((B, S, D), dtype=torch.float32, device="cuda")
    h = torch.empty((B, D, N), dtype=torch.float32, device="cuda")
    runs = {name: _launcher(
        fn, *(t.data_ptr() for t in args), y.data_ptr(), h.data_ptr(), 1, B,
        S, D, N, *x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2],
        *Cm.stride()[:2]) for name, fn in fns.items()}
    y_p, h_p = ref.selective_scan_ref(*args)

    def check(name):
        return {"y_max_row_err": float(ref.row_errors(y, y_p).max()),
                "state_unequal": int((h != h_p).sum()),
                "state_max_row_err": float(ref.row_errors(h, h_p).max())}

    out = {"shape": SHAPE, **_alternating(runs, check),
           "ptxas": {name: ptxas(lib.with_suffix(".log").read_text(),
                                 "selective_scan_kernel")
                     for name, lib in libs.items()}}
    del y_p, h_p
    lib = build.load()
    out["this_blocks_per_sm"] = {
        f"{'bf16' if bf else 'f32'}_{'aligned' if al else 'unaligned'}":
            lib.selective_scan_blocks_per_sm(bf, al)
        for bf in (1, 0) for al in (1, 0)}
    if "--probe" in argv:
        out["rate_probes"] = rate_probes(ROOT / "_checkout")
    if "--sass" in argv:
        out["sass"] = {}
        for name, lib_path in libs.items():
            out["sass"][name] = {
                fn: step_loop_report(ins, _tile(sources[name]), N)
                for fn, ins in sass_functions(lib_path).items()
                if "selective_scan_kernel" in fn}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
