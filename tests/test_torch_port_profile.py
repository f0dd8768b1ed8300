"""The profile tools' attribution rules (``tools/profile_common.py``), on the
CPU: one train step of a small two-stage model traced by ``torch.profiler``
with the model's module ranges, each op's CPU self time attributed as the
card's kernels are (counterparts of the HLO op-name reading of the JAX
package's ``tools/profile_train_components.py``), and the card's branch
(kernels tied to their ops) on a hand-built trace."""

import collections

import pytest
import torch

from pixelwiseregression_tpu_torch.models.layers import InstanceNorm
from pixelwiseregression_tpu_torch.tools import ab_common, profile_common as pc
from pixelwiseregression_tpu_torch.tools.profile_train_components import RANGES
from pixelwiseregression_tpu_torch.train import loop

from torch_port_threads import one_thread  # noqa: F401 (autouse)

EVAL = pc.EVALUATE


@pytest.fixture(scope="module")
def traced():
    call, model = ab_common.train_step_call(torch.device("cpu"), 2, joints=5, stages=2,
                                            features=16, level=2)
    call()
    return pc.profile(call, 1, torch.device("cpu"), model, RANGES), model


def _paths(model, kind):
    return sorted(p for p, m in model.named_modules() if isinstance(m, kind))


def _where(prof, name, kind):
    """The paths of the leaves named ``name``, all of ``kind``."""
    leaves = [leaf for leaf in prof.leaves if leaf.name == name]
    assert {leaf.kind for leaf in leaves} == {kind}, (name, {leaf.kind for leaf in leaves})
    return sorted(leaf.where for leaf in leaves)


def test_forward_ops_land_in_their_modules(traced):
    """Each conv's, norm's and relu's forward op in [fwd] of its own module,
    the decoder's in its stage's; at depth 3 the component is the path cut
    to three parts."""
    prof, model = traced
    convs = _paths(model, torch.nn.Conv2d)
    assert _where(prof, "aten::convolution", "fwd") == convs
    assert _where(prof, "_InstanceNormFn", "fwd") == _paths(model, InstanceNorm)
    assert _where(prof, "aten::relu", "fwd") == _paths(model, torch.nn.ReLU)
    assert _where(prof, "_Decode", "fwd") == ["stages.0", "stages.1"]
    assert _where(prof, "pwr::softargmax_fwd", "fwd") == ["stages.0", "stages.1"]
    for leaf in prof.leaves:
        if leaf.name == "aten::convolution":
            assert pc.component(leaf.kind, leaf.where, 3) == \
                "[fwd] " + ".".join(leaf.where.split(".")[:3])


def test_backward_ops_land_in_the_same_modules(traced):
    """Each node's backward in [bwd] of the module whose forward made it,
    the hand backwards of ``_InstanceNormFn`` and ``_Decode`` included (the
    plain decoder's backward runs autograd inside ``_DecodeBackward``: its
    nested nodes stay in the stage), and the ops inside each backward too."""
    prof, model = traced
    assert _where(prof, EVAL + "ConvolutionBackward0", "bwd") == _paths(model, torch.nn.Conv2d)
    assert _where(prof, EVAL + "_InstanceNormFnBackward", "bwd") == _paths(model, InstanceNorm)
    assert _where(prof, EVAL + "ReluBackward0", "bwd") == _paths(model, torch.nn.ReLU)
    assert _where(prof, EVAL + "_DecodeBackward", "bwd") == ["stages.0", "stages.1"]
    assert _where(prof, "aten::convolution_backward", "bwd") == _paths(model, torch.nn.Conv2d)
    comps = pc.by_component(prof, 3)
    for s in ("stages.0", "stages.1"):
        for part in ("hourglass", "plane_regression", "depth_regression", "conv"):
            assert f"[fwd] {s}.{part}" in comps and f"[bwd] {s}.{part}" in comps, (s, part)


def test_attributed_time_sums_to_the_total(traced):
    """Every leaf attributed; the leaves' self times sum to the threads'
    outermost spans (the total counted apart), relative gap <= 1e-6; the
    split covers the total."""
    prof, _ = traced
    assert not prof.unattributed
    assert prof.total_us > 0
    assert abs(prof.attributed_us - prof.total_us) <= 1e-6 * prof.total_us
    split = pc.split(prof)
    assert split["fwd"] > 0 and split["bwd"] > 0 and split["non-model"] > 0
    assert abs(sum(split.values()) - prof.total_us) <= 1e-6 * prof.total_us
    busy, span = pc.busy(prof)
    assert 0 < busy <= span


def test_preprocess_loss_and_optimizer_are_non_model(traced):
    """The named ranges and the optimizer's own range hold only non-model
    leaves; no model path holds an optimizer or preprocess op."""
    prof, _ = traced
    comps = pc.by_component(prof, 3)
    for label in ("preprocess", "loss", "Optimizer.step#AdamW.step", "[bwd] loss"):
        assert f"<non-model> {label}" in comps, sorted(comps)
    for leaf in prof.leaves:
        if leaf.name.startswith(("Optimizer.", "aten::_foreach")) or leaf.name == "preprocess":
            assert leaf.kind == "non-model", leaf
    # a parameter's gradient accumulation has no forward op: non-model, once a
    # parameter; the ones inside the plain decoder's backward are the stage's
    acc = [leaf for leaf in prof.leaves if leaf.name == EVAL + "torch::autograd::AccumulateGrad"]
    outer = [leaf for leaf in acc if leaf.kind == "non-model"]
    assert {leaf.where for leaf in outer} == {"[bwd] torch::autograd::AccumulateGrad"}
    assert len(outer) == sum(1 for _ in traced[1].parameters())
    assert {(leaf.kind, leaf.where) for leaf in acc if leaf.kind != "non-model"} == \
        {("bwd", "stages.0"), ("bwd", "stages.1")}


def test_depth_one_merges_depth_three(traced):
    """The depth-1 table is the depth-3 table summed over each component's
    first path part."""
    prof, _ = traced
    merged = collections.defaultdict(lambda: [0.0, 0])
    for comp, (us, n) in pc.by_component(prof, 3).items():
        if comp.startswith("[") and not comp.endswith("<model-root>"):
            kind, path = comp.split(" ", 1)
            comp = f"{kind} {path.split('.')[0]}"
        merged[comp][0] += us
        merged[comp][1] += n
    one = pc.by_component(prof, 1)
    assert set(one) == set(merged)
    assert {k for k in one if k.startswith("[fwd]")} == {"[fwd] conv", "[fwd] stages",
                                                        "[fwd] <model-root>"}
    for comp, (us, n) in one.items():
        assert n == merged[comp][1] and us == pytest.approx(merged[comp][0], rel=1e-9), comp


def test_hooks_and_ranges_are_removed(traced):
    """After the trace, no module keeps a hook and the patched functions are
    the module's own again."""
    _, model = traced
    assert all(not m._forward_pre_hooks and not m._forward_hooks for m in model.modules())
    assert loop.preprocess_batch.__module__ == "pixelwiseregression_tpu_torch.data.preprocess"
    assert loop.stage_losses.__qualname__ == "stage_losses"


def _op(name, ts, dur, ext, tid=1, seq=None, cat="cpu_op"):
    args = {"External id": ext}
    if seq is not None:
        args["Sequence number"] = seq
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _kernel(name, ts, dur, ext=None, corr=None):
    args = {} if ext is None else {"External id": ext}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7, "args": args}


def test_card_branch_ties_kernels_to_their_ops():
    """On a hand-built card trace: kernels tied to their ops by External id
    or through the runtime call's correlation; a forward op in a module
    range, its node's backward on another thread (the same sequence number
    from that thread's counter is a recompute's, which must not take the
    label), a recompute's op inside the backward, the optimizer's range,
    and a kernel no op launched."""
    m = pc.MODULE_RANGE
    events = [
        _op(m, 0, 100, 1, cat="user_annotation"),
        _op(m + "stages.0", 1, 98, 2, cat="user_annotation"),
        _op(m + "stages.0.hourglass", 2, 40, 3, cat="user_annotation"),
        _op("aten::convolution", 3, 10, 4, seq=5),
        _op("_Decode", 50, 20, 5, seq=6),
        _op("pwr::softargmax_fwd", 51, 18, 6),
        # the backward thread
        _op(EVAL + "_DecodeBackward", 200, 10, 7, tid=2, seq=6),
        _op("_DecodeBackward", 201, 8, 8, tid=2, seq=6),
        _op(EVAL + "ConvolutionBackward0", 220, 30, 9, tid=2, seq=5),
        _op("aten::convolution_backward", 221, 10, 10, tid=2),
        _op(m + "stages.0.hourglass", 235, 10, 11, tid=2, cat="user_annotation"),
        _op("aten::mul", 236, 5, 12, tid=2, seq=6),
        _op("Optimizer.step#AdamW.step", 300, 20, 13, cat="user_annotation"),
        _op("aten::_foreach_add_", 301, 5, 14),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 202, "dur": 1,
         "tid": 2, "args": {"External id": 8, "correlation": 99}},
        _kernel("conv_fwd", 400, 3.0, ext=4),
        _kernel("softargmax_fwd_kernel", 404, 1.0, ext=6),
        _kernel("softargmax_bwd_kernel", 406, 2.0, corr=99),
        _kernel("dgrad", 409, 4.0, ext=10),
        _kernel("recompute_mul", 414, 0.5, ext=12),
        _kernel("adam", 415, 1.5, ext=14),
        _kernel("orphan", 417, 0.25, ext=1234),
    ]
    prof = pc.attribute(events, "cuda")
    got = {leaf.name: pc.component(leaf.kind, leaf.where, 3) for leaf in prof.leaves}
    assert got == {"conv_fwd": "[fwd] stages.0.hourglass",
                   "softargmax_fwd_kernel": "[fwd] stages.0",
                   "softargmax_bwd_kernel": "[bwd] stages.0", "dgrad": "[bwd] stages.0.hourglass",
                   "recompute_mul": "[fwd] stages.0.hourglass",
                   "adam": "<non-model> Optimizer.step#AdamW.step", "orphan": pc.UNATTRIBUTED}
    assert prof.total_us == pytest.approx(12.25)
    assert prof.attributed_us == pytest.approx(12.0)
    assert [leaf.name for leaf in prof.unattributed] == ["orphan"]
    assert pc.busy(prof) == (pytest.approx(12.25), pytest.approx(17.25))


def _runtime(ts, corr, tid=1, ext=None):
    args = {"correlation": corr}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": args}


def test_card_branch_ties_by_span_and_leaves_out_stale_records():
    """On a hand-built card trace: a launch whose external correlation was
    lost is tied to the innermost CPU event on its runtime call's thread
    whose span holds the call (a later sibling that ended first does not
    take it); a runtime call on a thread with no CPU event leaves its kernel
    unattributed; a device record that started before the first CPU event
    (an earlier session's) is counted as stale and left out of the leaves
    and the total."""
    m = pc.MODULE_RANGE
    events = [
        _op(m, 10, 100, 1, cat="user_annotation"),
        _op(m + "stages.0", 11, 60, 2, cat="user_annotation"),
        _op("aten::add", 12, 10, 3),
        _op("aten::mul", 30, 5, 4),
        _op("aten::sum", 80, 10, 5),
        _runtime(14, 1, ext=None),
        _runtime(40, 2, ext=None),
        _runtime(50, 3, tid=9),
        _runtime(85, 4, ext=5),
        _kernel("add_lost_link", 120, 2.0, corr=1),
        _kernel("in_range_only", 122, 1.0, corr=2),
        _kernel("other_thread", 124, 0.5, corr=3),
        _kernel("sum", 125, 1.5, corr=4),
        _kernel("earlier_session", 2, 4.0, ext=3, corr=1),
    ]
    prof = pc.attribute(events, "cuda")
    got = {leaf.name: pc.component(leaf.kind, leaf.where, 3) for leaf in prof.leaves}
    assert got == {"add_lost_link": "[fwd] stages.0", "in_range_only": "[fwd] stages.0",
                   "other_thread": pc.UNATTRIBUTED, "sum": "[fwd] <model-root>"}
    assert (prof.stale, prof.by_span) == (1, 2)
    assert prof.total_us == pytest.approx(5.0)
    assert [leaf.name for leaf in prof.unattributed] == ["other_thread"]
