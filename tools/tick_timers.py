"""Where a tick of the wide fused kernel goes: clock64 section timers.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/tick_timers.py

It copies ``grid_tick.cu`` under ``build/tick_timers/`` and replaces the
``// tick_timers:`` marker lines that ``bank_fused_wide_kernel`` keeps in
its tick loop with timers: lane 0 of each warp adds the ``clock64()`` cycles since the last
mark (each mark after a ``__syncwarp()``) to the section the marker
closes, and the totals of every warp go to a ``__device__`` buffer that an
exported function reads back. The copy is built beside the untimed
source with the repository's ``nvcc`` flags. The sections: the done
ballot, the background refresh, the activity, the process counts, the
link counts (with the per-process bandwidth), the shares, the process
sums, the link sums, the update of the legs in registers and the update
of the legs past them.

Both builds run one K = 32 window (``chip_smoke.first_window``) through
this checkout's wrappers at the long tail's widest bucket (S 3, R 64, T
196, P 196, L 2), the serving bench's widest slot bank (T 256, P 256, L 8)
and the long tail's bucket with the longest lists (T 152: processes of 60
legs, a link of 127 processes). One JSON line a build and shape: bits
against ``ref.grid_tick_bank_window``, device time (``chip_smoke.device_ms``)
and, for a timed build, cycles a tick by section; then the card's name,
power limit and SM clocks. The timers cost the timed build a few percent
of device time and some registers: compare splits, not times, across
builds.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import ab_kernels as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch import Fleet  # noqa: E402
from repro_torch.kernels import _build, grid_tick, ref  # noqa: E402

SECTIONS = ("done_ballot", "bg_refresh", "activity", "proc_counts", "link_counts", "shares",
            "proc_sums", "link_sums", "slot_update", "past_update")
OUT = os.path.join(ROOT, "build", "tick_timers")
MAX_WARPS = 8192

TIMER = f"""
constexpr int kSections = {len(SECTIONS)};
struct Timer {{
  long long acc[kSections];
  long long last;
  __device__ __forceinline__ void start() {{
    for (int i = 0; i < kSections; ++i) acc[i] = 0;
    __syncwarp();
    last = clock64();
  }}
  __device__ __forceinline__ void mark(int i) {{
    __syncwarp();
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
  }}
}};
__device__ long long g_timers[{MAX_WARPS}][kSections + 1];
"""
SAVE = f"""
  if (lane == 0) {{
    const int slot = (blockIdx.x * gridDim.y + blockIdx.y) * kBankWarps + warp;
    if (slot < {MAX_WARPS}) {{
      for (int i = 0; i < kSections; ++i) g_timers[slot][i] = tmr.acc[i];
      g_timers[slot][kSections] = ticks;
    }}
  }}
"""
READ = """
int grid_tick_timers(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_timers, sizeof(long long) * n * (kSections + 1));
}
"""
MARKS = {"start": "  Timer tmr;\n  long long ticks = 0;\n  tmr.start();",
         "done_ballot": "    tmr.mark(0);\n    ++ticks;",
         **{name: f"    tmr.mark({i});" for i, name in enumerate(SECTIONS) if i},
         "save": SAVE.rstrip("\n")}


def timed_source(src: str) -> str:
    """``src`` with section timers in ``bank_fused_wide_kernel``: each
    ``// tick_timers: <name>`` line replaced by its code in ``MARKS``."""
    lines, seen = [], set()
    for line in src.split("\n"):
        name = line.strip().removeprefix("// tick_timers: ")
        if line.strip().startswith("// tick_timers: ") and name in MARKS:
            lines.append(MARKS[name])
            seen.add(name)
        else:
            lines.append(line)
    if seen != set(MARKS):
        raise ValueError(f"tick_timers: markers missing from the kernel: {sorted(set(MARKS) - seen)}")
    src = "\n".join(lines)
    at = src.index("namespace {\n") + len("namespace {\n")
    return src[:at] + TIMER + src[at:] + "\nextern \"C\" " + READ.lstrip()


def build(sources: dict) -> dict:
    """Each ``label -> .cu path`` built with the repository's flags, all at
    once; the libraries bound with this checkout's C signatures."""
    os.makedirs(OUT, exist_ok=True)
    procs = {label: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(OUT, f"lib{label}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, path in sources.items()}
    ours, libs = grid_tick._lib(), {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label} did not build:\n{log}")
        ptxas = {k: v for k, v in cs.ptxas_by_kernel(log).items() if "fused_wide" in k}
        print(json.dumps(dict(build=label, ptxas=ptxas)), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{label}.so"))
        for fn in ("grid_tick_bank_fused_launch", "grid_tick_bank_launch",
                   "grid_tick_bank_sums_launch", "grid_tick_limits", "grid_tick_campaign_limits"):
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
        if hasattr(lib, "grid_tick_timers"):
            lib.grid_tick_timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[label] = lib
    return libs


def run(libs: dict, label: str, spec, p, R: int, dev) -> None:
    S, T = spec.size_mb.shape
    P, L = spec.leg_proc.shape[-1], spec.bandwidth.shape[-1]
    state, noise, mu, sigma, consts = cs.first_window(spec, p, R, dev)
    tables = spec.bank_tables
    want = ref.grid_tick_bank_window(state, mu, sigma, *consts, leap=False, noise=noise,
                                     tables=tables)
    call = lambda: grid_tick.grid_tick_bank_fused_cuda(state, noise, mu, sigma, *consts[:6], tables)
    for name, lib in libs.items():
        fn = ab.through(lib, call)
        got = fn()
        row = dict(build=name, shape=label, dims=[32, S, R, T, P, L],
                   bitwise=all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
                   device_ms=cs.device_ms(fn, 20, "bank_fused"))
        if hasattr(lib, "grid_tick_timers"):
            buf = torch.zeros((MAX_WARPS, len(SECTIONS) + 1), dtype=torch.int64)
            fn()
            torch.cuda.synchronize()
            if lib.grid_tick_timers(buf.data_ptr(), MAX_WARPS) != 0:
                raise RuntimeError("grid_tick_timers failed")
            warps = buf[:S * -(-R // grid_tick._WARPS_PER_BLOCK) * grid_tick._WARPS_PER_BLOCK]
            ticks = float(warps[:, -1].sum())
            row["ticks"] = int(ticks)
            row["cycles_per_tick"] = {s_: float(warps[:, i].sum()) / ticks
                                      for i, s_ in enumerate(SECTIONS)}
            row["cycles_per_tick_total"] = sum(row["cycles_per_tick"].values())
        print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tick_timers: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(str(_build.CSRC), "grid_tick.cu")
    timed = os.path.join(OUT, "grid_tick_timed.cu")
    with open(path) as f, open(timed, "w") as out:
        out.write(timed_source(f.read()))
    libs = build({"this": path, "this_timed": timed})
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
           "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    run(libs, "long_tail_widest", *cs.widest_long_tail(dev), dev)
    run(libs, "serve_256", *cs.serve_wide_bank(dev), dev)
    fleet = Fleet.from_scenarios(**cs.LONG_TAIL, device=dev)
    sub = next(b.bank for b in fleet.bank.buckets if b.bank.pad_legs == 152)
    run(libs, "long_tail_T152", *cs.long_tail_bucket(sub, dev), dev)
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
