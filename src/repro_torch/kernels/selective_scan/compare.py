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
``-Xptxas -v`` lines, the median ms of each build over rounds that
alternate their order, and the SM clock and power read while they ran.

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
from . import build, ref

ROOT = Path(__file__).resolve().parents[4]
ROUNDS, REPS = 6, 5
#: jamba's prefill: batch, steps, d_inner, states
SHAPE = (2, 32_768, 16_384, 16)
#: copies of this checkout's source with one line changed; ``unaligned``
#: launches the instance that reads each row's offset at jamba's aligned
#: rows too
VARIANTS = {
    "unaligned": ("return aligned ? launch_instance<T, 16, 1>",
                  "return false ? launch_instance<T, 16, 1>"),
    "channels32": ("constexpr int CHANNELS = 64;",
                   "constexpr int CHANNELS = 32;"),
    "tile16": ("constexpr int TILE = 32;", "constexpr int TILE = 16;"),
    "tile64": ("constexpr int TILE = 32;", "constexpr int TILE = 64;"),
    "unroll2": ("#pragma unroll 4\n", "#pragma unroll 2\n"),
    "unroll8": ("#pragma unroll 4\n", "#pragma unroll 8\n"),
}
#: diagnostic copies, timed but not meant to be right: ``noload`` copies
#: the first tile only and scans whatever the ring holds after it (the
#: scan's arithmetic and stores without the loads)
PROBES = {
    "noload": ("    if (k + 1 < tiles) issue(k + 1);\n", ""),
}
SMS, CLOCK_HZ, SCHEDULERS = 132, 1.98e9, 4

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


def main(argv: list[str]) -> None:
    sass = "--sass" in argv
    sources = {"this": build.SOURCE}
    libs = {"this": build.build()}
    scratch = ROOT / "_checkout"
    scratch.mkdir(exist_ok=True)
    if "--variants" in argv or "--probe" in argv:
        text = build.SOURCE.read_text()
        chosen = {**(VARIANTS if "--variants" in argv else {}),
                  **(PROBES if "--probe" in argv else {})}
        for name, (old, new) in chosen.items():
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not once in the "
                                 f"source")
            src = scratch / f"selective_scan_{name}.cu"
            src.write_text(text.replace(old, new))
            sources[name] = src
    for other in (a for a in argv if not a.startswith("--")):
        sources[other] = Path(other).resolve()
    others = [name for name in sources if name != "this"]
    with ThreadPoolExecutor(max(1, len(others))) as pool:   # nvcc at once
        libs.update(zip(others, pool.map(_build, (sources[n]
                                                  for n in others))))
    fns = {}
    for name, lib in libs.items():   # the entry point every build has
        fn = fns[name] = ctypes.CDLL(str(lib)).selective_scan
        fn.argtypes, fn.restype = build.SCAN_ARGTYPES, ctypes.c_int

    B, S, D, N = SHAPE
    x, dt, A, Bm, Cm = args = ref.scan_inputs(B, S, D, torch.bfloat16, 7)
    y = torch.empty((B, S, D), dtype=torch.float32, device="cuda")
    h = torch.empty((B, D, N), dtype=torch.float32, device="cuda")

    def runner(fn):
        def run():
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(), h.data_ptr(), 1, B, S, D, N,
                    *x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2],
                    *Cm.stride()[:2], torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
        return run

    runs = {name: runner(fn) for name, fn in fns.items()}
    y_p, h_p = ref.selective_scan_ref(*args)
    errs = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        errs[name] = {"y_max_row_err": float(ref.row_errors(y, y_p).max()),
                      "state_unequal": int((h != h_p).sum()),
                      "state_max_row_err": float(ref.row_errors(h, h_p)
                                                 .max())}
    del y_p, h_p
    times = {name: [] for name in runs}
    # the card's SM clock and power while the rounds run, every 100 ms
    smi_log = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        for r in range(ROUNDS):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[name].append(cuda_ms(runs[name], REPS))
    finally:
        smi_log.terminate()
        samples = [[float(v) for v in ln.split(",")]
                   for ln in smi_log.communicate()[0].splitlines()
                   if ln.count(",") == 1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "shape": SHAPE, "errors": errs,
           "ptxas": {name: [ln.strip() for ln in lib.with_suffix(".log")
                            .read_text().splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, lib in libs.items()},
           "median_ms": {k: sorted(v)[ROUNDS // 2] for k, v in times.items()},
           "ms": times,
           "while_timed": {"sm_clock_mhz": sorted(c for c, _ in samples),
                           "power_w": sorted(w for _, w in samples)}}
    lib = build.load()
    out["this_blocks_per_sm"] = {
        f"{'bf16' if bf else 'f32'}_{'aligned' if al else 'unaligned'}":
            lib.selective_scan_blocks_per_sm(bf, al)
        for bf in (1, 0) for al in (1, 0)}
    if "--probe" in argv:
        out["rate_probes"] = rate_probes(scratch)
    if sass:
        out["sass"] = {}
        for name, lib_path in libs.items():
            out["sass"][name] = {
                fn: step_loop_report(ins, _tile(sources[name]), N)
                for fn, ins in sass_functions(lib_path).items()
                if "selective_scan_kernel" in fn}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
