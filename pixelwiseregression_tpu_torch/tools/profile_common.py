"""A call's time split by model component and by direction, from one
``torch.profiler`` trace: the attribution shared by the port's profile tools
(the counterpart of the HLO ``op_name`` reading in the JAX package's
``tools/profile_components.py`` and ``tools/profile_train_components.py``).

The JAX tools read each fused op's flax module path from the HLO metadata,
and take an op whose path holds ``transpose(jvp(...))`` for backward work.
Here:

* ``module_ranges(model)`` adds, for the length of a ``with`` block, forward
  pre- and post-hooks to every submodule of ``model`` that open and close a
  ``record_function`` range named ``MODULE_RANGE + path``, ``path`` as
  ``model.named_modules()`` gives it (``stages.0.hourglass.inner...``; the
  empty path is the model itself). The model's code is not touched;
* ``named_ranges([(label, owner, attribute), ...])`` runs a function that
  the traced call looks up at run time (``train.loop.preprocess_batch``)
  inside a range named ``label``, to name the parts outside the model;
* the trace gives each CPU event its thread and span, hence which events
  nest it, and the autograd sequence number a forward op took. The autograd
  engine's ``autograd::engine::evaluate_function: XBackward0`` carries the
  sequence number of the forward op that made its node: PyTorch's
  counterpart of ``transpose(jvp(...))``;
* a device event (kernel, memcpy, memset) names the CPU op that launched it
  by ``External id``, or through its runtime call's ``correlation``: the
  call's ``External id``, else the innermost CPU event on the call's thread
  whose span holds the call (CUPTI may deliver a launch without its
  external correlation). A kernel launched through ctypes (K2, in
  ``_Decode.backward``) has no ATen op of its own: its op is the backward
  node, ``_DecodeBackward``;
* a device event that started before the trace's first CPU event is a
  record of an earlier session (the card is synchronised before the window
  opens, and CUPTI may hand a late record to the next session): it is
  counted in ``Profile.stale`` and left out.

The rules, for a CPU event (an op, or the op that launched a device event),
walking the events that enclose it outward:

1. a module range reached before any ``evaluate_function``: ``[fwd] path``
   (remat's recompute, inside the backward, is forward work and lands here);
2. otherwise, inside an ``evaluate_function``: the label of the forward op
   whose sequence number the outermost one carries, so ``[bwd] path`` for a
   model op and ``<non-model> [bwd] label`` for another one (outermost: a
   backward that runs autograd itself, as the decoder's plain backward on
   the CPU does, nests another); ``<non-model> [bwd] Node`` for a node no
   traced forward op made (``AccumulateGrad``);
3. otherwise ``<non-model> label``, ``label`` the name of the outermost
   event that is not one of the program's own spans (``obs``: the train
   step and its phases wrap everything else): a named range
   (``preprocess``, the optimizer's own ``Optimizer.step#AdamW.step``) or
   the op itself.

A sequence number's label is that of the last op (by start) that took it:
the op that made the node takes it last, since an op that makes none leaves
it to the next one. One Python thread must run the forward (sequence
numbers count per thread).

On the card the leaves are the device events, each with its device time;
on the CPU they are the CPU events, each with its self time (its span less
its children's), so that the rules can be checked without a card.
``component`` cuts a path to a depth: ``stages.0.hourglass`` at 3,
``stages`` at 1.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd.profiler import record_function

from pixelwiseregression_tpu_torch import obs

MODULE_RANGE = "pwr.module:"
EVALUATE = "autograd::engine::evaluate_function: "
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATS = ("cpu_op", "user_annotation")
UNATTRIBUTED = "<unattributed>"
# device time by kernel name, lowercased: the first group whose substring a
# name holds takes it, the rest is "other"
GROUPS = (
    ("decoder K1 + K2", ("softargmax", "dlabel_kernel")),
    ("cuDNN layout NCHW<->NHWC", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "xmma", "cutlass", "gemm", "cudnn", "sm90")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reduction", ("reduce",)),
    ("cast / copy", ("copy_kernel",)),
    ("elementwise", ("elementwise",)),
)
# a child may end this many microseconds after its parent (the trace's
# timestamps are rounded to the nanosecond)
_NEST_SLACK_US = 1e-2


@contextlib.contextmanager
def module_ranges(model: torch.nn.Module):
    """Every submodule's forward inside a ``record_function`` range named
    ``MODULE_RANGE + path`` while the block runs; the hooks go at its end."""
    local = threading.local()
    handles = []

    def pre(label):
        def hook(module, args):
            stack = getattr(local, "stack", None)
            if stack is None:
                stack = local.stack = []
            rf = record_function(label)
            rf.__enter__()
            stack.append(rf)
        return hook

    def post(module, args, output):
        local.stack.pop().__exit__(None, None, None)

    try:
        for path, module in model.named_modules():
            handles.append(module.register_forward_pre_hook(pre(MODULE_RANGE + path)))
            handles.append(module.register_forward_hook(post, always_call=True))
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def named_ranges(targets):
    """``[(label, owner, attribute), ...]``: while the block runs,
    ``owner.attribute`` (a function looked up at call time) runs inside a
    ``record_function`` range named ``label``."""
    saved = []

    def wrap(label, fn):
        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return ranged

    try:
        for label, owner, attr in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(label, fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


@dataclass
class Leaf:
    """One timed event: its name, microseconds (device time on the card,
    self time on the CPU), start and end (us, the trace's clock), and where
    it is attributed: ``kind`` "fwd", "bwd" or "non-model" (or None:
    unattributed) and the module path or the non-model label."""

    name: str
    us: float
    start: float
    end: float
    kind: str | None
    where: str


@dataclass
class Profile:
    """The leaves of a traced window and its total, counted apart from the
    leaves: on the card the device events' time, on the CPU the threads'
    outermost events' spans; ``wall_s``, the host's seconds for the traced
    calls (under the profiler); ``stale``, the device records of an earlier
    session left out; ``by_span``, the device events tied to their op
    through the span of their runtime call."""

    device: str
    calls: int
    leaves: list = field(default_factory=list)
    total_us: float = 0.0
    wall_s: float = 0.0
    stale: int = 0
    by_span: int = 0

    @property
    def attributed_us(self) -> float:
        return sum(leaf.us for leaf in self.leaves if leaf.kind is not None)

    @property
    def unattributed(self) -> list:
        return [leaf for leaf in self.leaves if leaf.kind is None]


def component(kind: str | None, where: str, depth: int) -> str:
    """The table's label of a leaf: ``[fwd] stages.0.hourglass`` (the path
    cut to ``depth`` dotted parts; ``<model-root>`` for the model's own
    forward), ``<non-model> label``, or ``<unattributed>``."""
    if kind is None:
        return UNATTRIBUTED
    if kind == "non-model":
        return f"<non-model> {where}"
    return f"[{kind}] {'.'.join(where.split('.')[:depth]) if where else '<model-root>'}"


def by_component(prof: Profile, depth: int) -> dict:
    """``{component: [us, leaves]}``, largest first."""
    out = defaultdict(lambda: [0.0, 0])
    for leaf in prof.leaves:
        row = out[component(leaf.kind, leaf.where, depth)]
        row[0] += leaf.us
        row[1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def by_name(prof: Profile) -> dict:
    """``{leaf name: [us, leaves]}``, largest first."""
    out = defaultdict(lambda: [0.0, 0])
    for leaf in prof.leaves:
        out[leaf.name][0] += leaf.us
        out[leaf.name][1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def group(name: str) -> str:
    """The ``GROUPS`` entry of a kernel's name (a module range, a leaf on the
    CPU only, is "other")."""
    if name.startswith(MODULE_RANGE):
        return "other"
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)), "other")


def grouped(prof: Profile, label) -> dict:
    """``{label(leaf): {group: us}}``, largest first, each split by
    ``GROUPS``."""
    out = defaultdict(lambda: defaultdict(float))
    for leaf in prof.leaves:
        out[label(leaf)][group(leaf.name)] += leaf.us
    return {k: dict(sorted(g.items(), key=lambda kv: -kv[1]))
            for k, g in sorted(out.items(), key=lambda kv: -sum(kv[1].values()))}


def by_module_class(prof: Profile, model: torch.nn.Module) -> dict:
    """``grouped`` by direction and the class of the innermost module that
    holds a model leaf (``[fwd] InstanceNorm``, ``[bwd] Conv``; ``[fwd]
    PredictionBlock`` holds the decoder), the others by their component."""
    classes = {path: type(m).__name__ for path, m in model.named_modules()}

    def label(leaf):
        if leaf.kind in ("fwd", "bwd"):
            return f"[{leaf.kind}] {classes.get(leaf.where, '?')}"
        return component(leaf.kind, leaf.where, 1)

    return grouped(prof, label)


def split(prof: Profile) -> dict:
    """Microseconds of model forward, model backward, non-model and
    unattributed leaves."""
    out = dict.fromkeys(("fwd", "bwd", "non-model", "unattributed"), 0.0)
    for leaf in prof.leaves:
        out[leaf.kind or "unattributed"] += leaf.us
    return out


def busy(prof: Profile) -> tuple[float, float]:
    """The union of the leaves' spans and the span from the first start to
    the last end, in us (on the card: the device's busy time and the
    window it is read over)."""
    spans = sorted((leaf.start, leaf.end) for leaf in prof.leaves)
    if not spans:
        return 0.0, 0.0
    total, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            total, lo, hi = total + hi - lo, start, end
        else:
            hi = max(hi, end)
    return total + hi - lo, max(end for _, end in spans) - spans[0][0]


class _Tree:
    """The trace's CPU events (ops and ranges) nested by thread and span;
    ``spans``, the names of the program's own spans, which no label takes."""

    def __init__(self, events, spans=frozenset()):
        self.events = [e for e in events if e.get("ph") == "X" and e.get("cat") in CPU_CATS]
        self.spans = spans
        self.parent = [-1] * len(self.events)
        by_tid = defaultdict(list)
        for i, e in enumerate(self.events):
            by_tid[e["tid"]].append(i)
        for idx in by_tid.values():
            idx.sort(key=lambda i: (float(self.events[i]["ts"]), -float(self.events[i]["dur"])))
            stack = []
            for i in idx:
                start, end = self._span(i)
                while stack and (start >= self._span(stack[-1])[1]
                                 or end > self._span(stack[-1])[1] + _NEST_SLACK_US):
                    stack.pop()
                if stack:
                    self.parent[i] = stack[-1]
                stack.append(i)
        self.by_external = {e["args"]["External id"]: i for i, e in enumerate(self.events)
                            if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
        self._labels = {}
        self._starts = None
        self.seq_labels = self._sequence_labels()

    def _span(self, i):
        e = self.events[i]
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    def opened(self) -> float:
        """The first CPU event's start (-inf for none)."""
        return min((self._span(i)[0] for i in range(len(self.events))), default=float("-inf"))

    def enclosing(self, tid, ts: float):
        """The innermost CPU event on thread ``tid`` whose span holds
        ``ts``, or None."""
        if self._starts is None:
            by_tid = defaultdict(list)
            for i in range(len(self.events)):
                start, end = self._span(i)
                by_tid[self.events[i]["tid"]].append((start, -(end - start), i))
            self._starts = {t: ([s for s, _, _ in sorted(v)], [i for _, _, i in sorted(v)])
                            for t, v in by_tid.items()}
        starts, idx = self._starts.get(tid, ((), ()))
        k = bisect.bisect_right(starts, ts) - 1
        if k < 0:
            return None
        return next((j for j in self._chain(idx[k])
                     if self._span(j)[0] <= ts <= self._span(j)[1]), None)

    def _chain(self, i):
        while i >= 0:
            yield i
            i = self.parent[i]

    def _forward_label(self, i):
        """Rules 1 and 3 for an event outside every backward (a recompute's
        ops count on another thread's sequence numbers): (kind, where), or
        None."""
        chain = [self.events[j]["name"] for j in self._chain(i)]
        if any(name.startswith(EVALUATE) for name in chain):
            return None
        path = next((name for name in chain if name.startswith(MODULE_RANGE)), None)
        if path is not None:
            return "fwd", path[len(MODULE_RANGE):]
        return "non-model", next((n for n in reversed(chain) if n not in self.spans), chain[0])

    def _sequence_labels(self):
        last = {}
        for i, e in enumerate(self.events):
            seq = e.get("args", {}).get("Sequence number")
            if seq is None or e["name"].startswith(EVALUATE):
                continue
            label = self._forward_label(i)
            if label is not None and (seq not in last or self._span(i)[0] >= last[seq][0]):
                last[seq] = (self._span(i)[0], label)
        return {seq: label for seq, (_, label) in last.items()}

    def label(self, i):
        """(kind, where) of CPU event ``i`` by the module docstring's rules."""
        if i in self._labels:
            return self._labels[i]
        outer, root = None, i
        for j in self._chain(i):
            name = self.events[j]["name"]
            if name.startswith(EVALUATE):
                outer = j
            elif name.startswith(MODULE_RANGE) and outer is None:
                out = ("fwd", name[len(MODULE_RANGE):])
                break
            if name not in self.spans:
                root = j
        else:
            if outer is None:
                out = ("non-model", self.events[root]["name"])
            else:
                ev = self.events[outer]
                kind, where = self.seq_labels.get(
                    ev.get("args", {}).get("Sequence number"),
                    ("non-model", ev["name"][len(EVALUATE):]))
                out = ("bwd", where) if kind == "fwd" else ("non-model", f"[bwd] {where}")
        self._labels[i] = out
        return out


def attribute(events, device: str, calls: int = 1) -> Profile:
    """The ``Profile`` of a chrome trace's ``traceEvents``: on ``cuda`` its
    device events attributed through the ops that launched them, on ``cpu``
    its CPU events by self time."""
    tree = _Tree(events, {s.name for s in obs.spans()})
    prof = Profile(device=device, calls=calls)
    if device == "cpu":
        child_us = defaultdict(float)
        for i, p in enumerate(tree.parent):
            if p >= 0:
                child_us[p] += float(tree.events[i]["dur"])
            else:
                prof.total_us += float(tree.events[i]["dur"])
        for i, e in enumerate(tree.events):
            start, end = tree._span(i)
            prof.leaves.append(Leaf(e["name"], float(e["dur"]) - child_us[i], start, end,
                                    *tree.label(i)))
        return prof
    runtime = {e["args"]["correlation"]: e
               for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    opened = tree.opened()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e["dur"])
        if start < opened:
            prof.stale += 1
            continue
        args = e.get("args", {})
        op = tree.by_external.get(args.get("External id"))
        call = runtime.get(args.get("correlation"))
        if op is None and call is not None:
            op = tree.by_external.get(call["args"].get("External id"))
            if op is None:
                op = tree.enclosing(call.get("tid"), float(call["ts"]))
                prof.by_span += op is not None
        kind, where = tree.label(op) if op is not None else (None, "")
        prof.leaves.append(Leaf(e["name"], dur, start, start + dur, kind, where))
        prof.total_us += dur
    return prof


def profile(fn, calls: int, device: torch.device, model: torch.nn.Module | None = None,
            ranges=()) -> Profile:
    """``calls`` calls of ``fn`` under ``torch.profiler`` (CPU and, on a
    card, CUDA activities), inside ``model``'s module ranges and the
    ``ranges`` of ``named_ranges``; the card is synchronised before the
    window closes. Warm ``fn`` up first: the window should see steady
    calls."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with contextlib.ExitStack() as stack:
        if model is not None:
            stack.enter_context(module_ranges(model))
        stack.enter_context(named_ranges(ranges))
        with torch.profiler.profile(activities=activities) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = attribute(events, device.type, calls)
    out.wall_s = wall_s
    return out


def print_components(prof: Profile, frames: int, depth: int, top: int, prefix: str = "") -> list:
    """Print the JAX tools' component table (us/frame, share, leaves a
    call) and return its rows ``[(component, us, leaves)]``."""
    total = prof.total_us or 1.0
    rows = [(comp, us, n) for comp, (us, n) in by_component(prof, depth).items()]
    for comp, us, n in rows[:top]:
        print(f"{prefix}  {us / frames:9.2f} us/frame {100 * us / total:5.1f}%  "
              f"({n / prof.calls:5.0f} ops a call)  {comp}", flush=True)
    return rows
