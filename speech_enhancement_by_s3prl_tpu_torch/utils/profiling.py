"""Step traces: a trace writer over ``torch.profiler`` and its reader
(counterpart of ``scripts/profile_step.py``'s ``jax.profiler.trace`` and
``parse_xplane``).

- ``trace(outdir, worker_name)`` records the calls inside it (the host's
  ops, and the card's kernels, copies and memsets when CUDA is available)
  and writes one Chrome trace, ``<worker_name>.<id>.pt.trace.json``, into
  ``outdir`` (``torch.profiler.tensorboard_trace_handler``, which needs no
  TensorBoard package). It waits for the card before it closes, as JAX's
  ``block_until_ready`` does, so the trace holds the calls' whole device
  work. It opens with ``PAD_LAUNCHES`` empty kernels on the card: in a
  process that has run for some minutes the first records of a session go
  missing (on an H100 with torch 2.11 and CUPTI 26, ``chip_smoke.py``
  phase 19 (c): a bare session 925 s into the run kept 7 of 64 kernels,
  one under ``trace`` all of them and its pads), so those places go to the
  pads, which ``parse_trace`` leaves out. ``run_downstream --profile`` and
  ``tools/profile_step.py`` write their traces with it.
- ``parse_trace(path, top)`` -> ``{plane: (total_ms, [(name, ms, count),
  ...])}``: the self-times of the trace's events summed per name, the
  ``top`` largest. Device planes (``/device:GPU:<n>``, one a card) hold the
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events but the pads; a
  kernel of this package is named by ``kernel_label`` (its template
  instance, so B1 and B2 fwd, one kernel with a cell flag, are two names),
  any other by ``kernel_op``. A trace with no device event (a run on the CPU) gives the
  host plane ``/host:CPU`` instead: the ``cpu_op`` events, each less the
  ops nested in it on its thread.
- ``report(tables, steps)`` prints the tables as the JAX script does.
- ``hand_written_launches(rows)`` counts the launches of each kernel of
  this package (B1 ... B7, D1) in a table's rows.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_PLANE = "/host:CPU"
# the trace's opening pads (the module docstring): torch.cuda._sleep's kernel
PAD_KERNEL, PAD_LAUNCHES = "spin_kernel", 256

# The kernels of csrc/ by name, each with the id of the wrapper that launches
# it. A wrapper's call launches each of its kernels once (B2 bwd's dW_hh^T sum
# only when its contraction is split), so its launches are those of its
# most-launched kernel. B1 and B2 fwd share a kernel with a cell flag, the
# first bool of its template (``lstm_tm_cluster.cu``, ``lstm_tm.cu``); B6 runs
# B1's kernel.
HAND_WRITTEN = {
    "lstm_tm_cluster_kernel": ("B1", "B2 fwd"),
    "lstm_bidir_tm_kernel": ("B1", "B2 fwd"),
    "lstm_bwd_gates_kernel": "B2 bwd",
    "lstm_bwd_seq_kernel": "B2 bwd",
    "lstm_bwd_dw_kernel": "B2 bwd",
    "lstm_bwd_dw_sum_kernel": "B2 bwd",
    "lstm_bidir_tm_bwd_kernel": "B2 bwd",
    "lstm_dw_bf16_kernel": "B2 bwd dW_hh^T bf16",
    "flash_fwd_kernel": "B3 fwd",
    "flash_fwd_bf16_kernel": "B3 fwd bf16",
    "flash_bwd_dot_kernel": "B3 bwd",
    "flash_bwd_dkdv_kernel": "B3 bwd",
    "flash_bwd_dq_kernel": "B3 bwd",
    "flash_bwd_prep_bf16_kernel": "B3 bwd bf16",
    "flash_bwd_dkdv_bf16_kernel": "B3 bwd bf16",
    "flash_bwd_dq_bf16_kernel": "B3 bwd bf16",
    "stft_fft_kernel": "B4",
    "stft_fused_kernel": "B4",
    "decode_fft_kernel": "B5",
    "decode_ola_kernel": "B5",
    "lstm_bb_cluster_kernel": "B7",
    "threefry_dropout_kernel": "D1",
}


@contextlib.contextmanager
def trace(outdir: str, worker_name: str):
    """Trace the calls inside the ``with`` block into ``outdir`` (the module
    docstring); yields the ``torch.profiler.profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(outdir, worker_name=worker_name)) as prof:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


def newest_trace(outdir: str) -> str:
    """The newest ``*.pt.trace.json`` under ``outdir``."""
    paths = [os.path.join(d, n) for d, _, names in os.walk(outdir) for n in names
             if n.endswith(".pt.trace.json")]
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {outdir}")
    return max(paths, key=os.path.getmtime)


def kernel_label(name: str) -> str:
    """A kernel of this package's name and template arguments, out of its
    mangled name (ptxas's report) or its demangled one (a profiler's);
    other names unchanged."""
    m = re.search(r"\d+((?:lstm|flash|stft|decode|threefry)[a-z0-9_]*kernel(?:I.*?E)?)E", name)
    if m:
        return m.group(1)
    m = re.search(r"\b((?:lstm|flash|stft|decode|threefry)[a-z0-9_]*kernel(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name


def kernel_op(name: str) -> str:
    """The op of a device kernel, out of its demangled name: the host
    function of an elementwise lambda, else the innermost functor and its
    type, else the kernel's name (with its first template argument where
    that names a GEMM, which a generic kernel template such as CUTLASS's
    ``Kernel2`` wraps)."""
    m = re.search(r"(\w+)\((?:at::)?TensorIteratorBase&\)", name)
    if m:
        return m.group(1)
    functors = re.findall(r"(\w+(?:Functor|Op))<([\w:]+)", name)
    if functors:
        return "{}<{}>".format(*functors[-1])
    m = re.match(r"(?:void )?([\w:]+)<(\w*gemm\w*)", name, re.IGNORECASE)
    if m:
        return "{}<{}>".format(*m.groups())[:90]
    return re.sub(r"^void |<.*$", "", name)[:60]


def kernel_id(label: str) -> Optional[str]:
    """The id (B1 ... B7, D1) of the wrapper that launches the kernel a table's
    row names, or None for a kernel of no wrapper of this package."""
    m = re.match(r"([a-z0-9_]*kernel)", label)
    ids = HAND_WRITTEN.get(m.group(1)) if m else None
    if isinstance(ids, tuple):
        flag = re.search(r"\b(true|false)\b|Lb([01])E", label)
        cell = flag is not None and (flag.group(1) == "true" or flag.group(2) == "1")
        return ids[cell]
    return ids


def hand_written_launches(rows: Iterable[Tuple[str, float, int]]) -> Dict[str, int]:
    """{kernel id: launches} of the kernels of this package in a table's rows
    (``parse_trace(..., top=None)``, so that none is cut off)."""
    launches: Dict[str, int] = {}
    for name, _, count in rows:
        kid = kernel_id(name)
        if kid is not None:
            launches[kid] = max(launches.get(kid, 0), count)
    return launches


def _device_name(name: str) -> str:
    label = kernel_label(name)
    return label if label != name else kernel_op(name)


def _self_times(events: List[dict]) -> List[Tuple[str, float]]:
    """(name, self µs) of host events: each event's duration less that of
    the events nested directly in it on its thread."""
    threads = defaultdict(list)
    for e in events:
        threads[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        open_ = []  # [end, name, self µs], innermost last
        for e in evs:
            ts, dur = float(e["ts"]), float(e["dur"])
            while open_ and open_[-1][0] <= ts:
                _, name, own = open_.pop()
                out.append((name, max(own, 0.0)))
            if open_:
                open_[-1][2] -= dur
            open_.append([ts + dur, e["name"], dur])
        out += [(name, max(own, 0.0)) for _, name, own in open_]
    return out


def parse_trace(path: str, top: Optional[int] = 40
                ) -> Dict[str, Tuple[float, List[Tuple[str, float, int]]]]:
    """{plane: (total ms, [(name, ms, count), ...])} of a Chrome trace (the
    module docstring), the rows by ms, the ``top`` largest (None: all)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    planes: Dict[str, List[Tuple[str, float]]] = defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES and PAD_KERNEL not in e["name"]:
            device = e.get("args", {}).get("device", e.get("pid"))
            planes[f"/device:GPU:{device}"].append((_device_name(e["name"]), float(e["dur"])))
    if not planes:
        planes[HOST_PLANE] = _self_times([e for e in events if e.get("cat") == "cpu_op"])
    tables = {}
    for plane, timed in sorted(planes.items()):
        agg = defaultdict(lambda: [0.0, 0])
        for name, us in timed:
            agg[name][0] += us / 1e3
            agg[name][1] += 1
        rows = sorted(((name, ms, n) for name, (ms, n) in agg.items()), key=lambda r: -r[1])
        tables[plane] = (sum(ms for _, ms, _ in rows), rows if top is None else rows[:top])
    return tables


def report(tables, steps: int = 1):
    """Print each plane's ms a step and its rows, as ``scripts/profile_step.py``
    does."""
    for plane, (total, rows) in tables.items():
        print(f"\n== plane {plane}: {total / steps:.2f} ms/step "
              f"(sum of event durations; {steps} steps) ==")
        for name, ms, count in rows:
            print(f"{ms / steps:9.3f} ms  x{count:<4d} {name[:110]}")
