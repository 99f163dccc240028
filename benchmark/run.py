"""Run one cell of the benchmark of ``camkifu_tpu_torch`` once.

    python3 benchmark/run.py --workload fixed19.streams --seed 7 \
        --seconds 10 --trace 0

The cell (``BENCHMARK.json``) names a configuration and a traffic mix;
the generator draws the cell's pool of frames on the card from the seed;
the configuration's driver sets up the system under test (it finds each
board itself) and runs the first batches from fresh states, which warm
every shape; the loop that the mix names (``loops/<loop>.py``) then
offers the pool's batches for ``--seconds``, the program's states running
on from batch to batch. After the window the plain reference works out
again the first batches, from fresh states, and a sample of the window's
batches drawn from the seed, each from the program's state before it,
and their outputs are compared with the program's.

``--trace 0`` prints the cell's end-to-end metrics (``frames_per_s``,
``batch_p95_ms``, ``setup_s``); ``--trace 1`` profiles a stretch of the
window with ``torch.profiler`` and prints the per-layer metrics, each read
by ``metrics/<name>.py``, with the device's busy time and a breakdown.
The last line of standard output is one JSON object; the numbers compared
with the reference, each beside its limit, are the last lines of
standard error and the result's last key (``checks``).

Exits non-zero with no result where there is no CUDA card (or fewer than
the cell asks for), and where a module of JAX or of the JAX package
(``camkifu_tpu``) is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Every build and kernel cache at a fixed path inside the checkout, so
# only a checkout's first run builds.
for _var, _sub in (("TRITON_CACHE_DIR", "build/triton"),
                   ("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                   ("CUDA_CACHE_PATH", "build/cuda_cache")):
    os.environ[_var] = str(ROOT / _sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "camkifu_tpu")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules, each
    module's name compared whole up to its first dot."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class TraceContext:
    """What a per-layer metric's reader reads of a traced stretch."""

    def __init__(self, cfg, mix, inputs, device_name):
        self.cfg, self.mix, self.inputs = cfg, mix, inputs
        self.device_name = device_name
        self.kernels = []        # (name, start µs, end µs) on the device
        self.runtime = []        # names of CUDA runtime / driver calls
        self.host_ops = []       # (name, start µs, end µs) on the host
        self.span_us = (0.0, 0.0)  # the stretch on the profiler's clock
        self.window_s = 0.0
        self.batches = []        # pool batch index of each completed batch
        self.frames = 0
        self.enqueue_s = []
        self._taps = {}

    def taps(self, r: int):
        """Distinct source pixels each frame of pool batch ``r`` needs."""
        if r not in self._taps:
            from benchmark.metrics._bytes import tap_pixels

            cfg = self.cfg
            c = self.inputs["corners"][r].reshape(-1, 4, 2)
            b = self.inputs["corners"].shape[2]
            k1 = self.inputs["k1"].repeat_interleave(b)
            self._taps[r] = tap_pixels(c, k1, tuple(cfg["frame_hw"]),
                                       cfg["gsize"], cfg["zone"])
        return self._taps[r]


#: Host events the profiler makes for itself: not what the program did.
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush", "ProfilerStep")


def _events(prof, ctx: TraceContext) -> None:
    """Sort the stretch's events: device operations (clipped to the
    stretch, which starts with the first host event after the profiler
    did), runtime calls, the host's other ops."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, *span))
        elif e.name.startswith("cu") and not e.name.startswith("cuda::"):
            ctx.runtime.append(e.name)
        elif not e.name.startswith(PROFILER_OWN):
            host.append((e.name, *span))
    ctx.host_ops = host
    if not host:
        return
    t0 = min(s for _, s, _ in host)
    t1 = t0 + ctx.window_s * 1e6
    ctx.kernels = [(n, max(s, t0), min(e, t1)) for n, s, e in device
                   if min(e, t1) > max(s, t0)]
    ctx.span_us = (t0, t1)


def _power_limit(index: int) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, wrap_program=None):
    """Run ``cell`` once → (result dict, lines for standard error).
    ``wrap_program`` (tests) takes the driver's program and returns the
    one to time."""
    import torch

    from benchmark import checks, spec
    from benchmark.metrics import _busy
    from benchmark.traffic import generator
    from benchmark.window import Recorder

    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # The configuration states float32 without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = {"start_s": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    if cuda:
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)          # the CUDA context
    drv = spec.driver(cfg)
    ref_mod = spec.reference(cfg)
    loop = spec.loop(mix)
    lap("context_and_imports_s")

    # -- set-up: the pool, the program, every shape warmed ------------------
    inputs = generator.make_inputs(cfg, mix, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    lap("pool_s")
    program = drv.Program(cfg, mix, inputs, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    lap("anchor_s")
    if wrap_program is not None:
        program = wrap_program(program)
    R, B, S = mix["pool_batches"], mix["batch_frames"], cfg["streams"]
    g = cfg["gsize"]
    # The first batches, from fresh states, warm every shape; their
    # outputs are the start that the check compares.
    warm = []
    for k in range(mix["warmup_batches"]):
        warm.append(program.step(k % R))
        warm[-1]["labels"].cpu()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if trace:
        # CUPTI starts on a profiler's first session: not in the window.
        with profile(activities=activities):
            torch.ones(1, device=dev).add_(1)
            if cuda:
                torch.cuda.synchronize(dev)
    if cuda:
        torch.cuda.synchronize(dev)
    lap("warmup_s")

    # -- the window -------------------------------------------------------------
    rec = Recorder(seconds, mix, (S, B, g, g), dev, trace, activities, seed)
    rec.start()
    setup_s = rec.t0 - t_start
    loop.run(program, mix, rec, mix["warmup_batches"])

    # -- after the window ---------------------------------------------------
    device_name = torch.cuda.get_device_name(dev) if cuda else str(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    result = {"correct": False, "attempted": rec.attempted, "failed": 0}
    ctx = TraceContext(cfg, mix, inputs, device_name)
    if trace:
        ctx.enqueue_s = [t for t, inside in rec.enqueue if not inside]
        metrics = {}
        if rec.stretch_batches:
            ctx.window_s = rec.window_s
            ctx.batches = rec.stretch_batches
            ctx.frames = len(ctx.batches) * S * B
            _events(rec.prof, ctx)
        for m in cell.metrics(trace=True):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            # Over the time in which that work was done: from the
            # window's start to the last labels that reached the host
            # inside it (not quantized to whole batches of the window).
            "frames_per_s": rec.done_in_window * S * B
            / max(rec.last_done - rec.t0, 1e-9),
            "batch_p95_ms": 1e3 * percentile(rec.latencies, 95),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics(trace=False)}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else dev.type, "kind": device_name,
        "count": cell.chips, "memory_peak_bytes": int(peak),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "power_limit": _power_limit(dev.index or 0) if cuda else None}
    if trace and ctx.kernels:
        busy = _busy.busy_union((s, e) for _, s, e in ctx.kernels) * 1e-6
        result["device"].update(busy_s=busy, window_s=ctx.window_s)
        result["breakdown"] = {
            "device_ops": [[n, t * 1e-6]
                           for n, t in _busy.top_ops(ctx.kernels)],
            "idle_gaps": [[n, t * 1e-6] for n, t in _busy.idle_gaps(
                [(s, e) for _, s, e in ctx.kernels], ctx.host_ops,
                *ctx.span_us)]}
    anchor = program.anchor
    kept, enqueue = rec.kept, rec.enqueue
    del program, rec, ctx
    if cuda:
        torch.cuda.empty_cache()

    # -- correctness: the reference over the start and the kept batches ----
    pairs = checks.pairs(ref_mod, cfg, inputs, anchor, warm, kept)
    values = checks.numbers(cfg["checks"], pairs)
    ok, table = checks.verdict(cfg["checks"], values)
    truth = inputs["truth"]
    misread = sum(int((got["labels"][:, -1] != truth[k, :, -1]).sum())
                  for k, _, got in kept)
    first = inputs["corners"][0, :, 0].to(anchor.device, torch.float32)
    result["failed"] = 0 if ok else len(pairs)
    result["correct"] = ok
    result["setup_parts"] = parts
    q = sorted(t for t, _ in enqueue)
    result["enqueue_ms_quartiles"] = [
        1e3 * percentile(q, p) for p in (25, 50, 75)] if q else []
    result["compared_batches"] = len(pairs)
    result["misread_vs_truth"] = misread
    result["anchor_gap_px"] = float(
        torch.linalg.vector_norm(anchor - first, dim=-1).max())
    result["checks"] = table
    lines = [f"check {name}: {t['value']!r} (limit {t['limit']!r})"
             for name, t in table.items()]
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
