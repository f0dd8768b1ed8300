"""The heads' f32 3x3 conv as a registered operator
(``ops/cuda_conv.py``, ``torch.ops.pwr.conv3x3_f32``) on the CPU: the rule
by which ``layers.Conv`` takes it, its plain version against ``F.conv2d``
forward and backward, its fake shapes, an exported program's nodes, and the
benchmark's reader of its device time. Its kernel runs on the card only
(``tests/test_torch_port_cuda.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from pixelwiseregression_tpu_torch import obs
from pixelwiseregression_tpu_torch.models import layers
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.ops import cuda_conv
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact, export_artifact

from torch_port_threads import one_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _config_model(name):
    """The benchmark configuration's model (``port_bench/configs``), built on
    the meta device: shapes only."""
    m = json.loads((REPO / "port_bench" / "configs" / f"{name}.json").read_text())["model"]
    with torch.device("meta"):
        if m["class"] == "FullRegression":
            model = FullRegression(m["joints"], stage=m["stages"], label_size=m["label_size"],
                                   features=m["features"], level=m["level"])
        else:
            model = PixelwiseRegression(m["joints"], stage=m["stages"], features=m["features"],
                                        level=m["level"], kernel_size=m["filter_size"],
                                        decoder=m["decoder"])
    return model, m


@pytest.mark.parametrize("name, taken", [("nyu_pixelwise", 12), ("hand17_pixelwise", 12),
                                         ("nyu_fullreg", 0)])
def test_the_rule_over_every_conv_of_each_configuration(name, taken, monkeypatch):
    """Every conv of the benchmark's three configurations, on the input it
    sees in an f32 forward, takes the operator exactly when it is 3x3,
    stride 1, with input and output channels multiples of 128, on a
    contiguous f32 input 64 wide: the pixelwise heads' twelve 128 -> 128
    convs (three a head, two heads, two stages) and none of FullRegression's
    (stride-2 head convs, 64-channel ResBlocks, a 64 -> 128 stem)."""
    model, m = _config_model(name)
    seen = []

    def hook(conv, args):
        x = args[0]
        want = (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
                and conv.in_channels % 128 == 0 and conv.out_channels % 128 == 0
                and x.dtype == torch.float32 and x.shape[3] == 64 and x.is_contiguous())
        seen.append((conv.in_channels, conv.out_channels, conv.kernel_size[0], conv.stride[0],
                     tuple(x.shape[2:]), conv.hand_f32 and cuda_conv.takes(x), want))

    for conv in model.modules():
        if isinstance(conv, layers.Conv):
            conv.register_forward_pre_hook(hook)
    calls = []
    op = cuda_conv.conv3x3_f32
    monkeypatch.setattr(cuda_conv, "conv3x3_f32", lambda *a: calls.append(a) or op(*a))
    s = m["image_size"]
    with torch.no_grad(), torch.device("meta"):
        model.eval()(torch.empty(1, 1, s, s), torch.empty(1, 1, s // 2, s // 2),
                     torch.empty(1, 1, s // 2, s // 2))
    assert [row[:5] for row in seen if row[5] != row[6]] == []
    assert sum(row[5] for row in seen) == len(calls) == taken
    assert {row[:5] for row in seen if row[5]} <= {(128, 128, 3, 1, (64, 64))}


def _conv(cin, cout, k=3, stride=1, quant=None):
    torch.manual_seed(0)
    return layers.Conv(cin, cout, k, stride=stride, quant=quant)


@pytest.mark.parametrize("case, cin, cout, k, stride, quant, dtype, side, layout, taken", [
    ("head", 128, 128, 3, 1, None, torch.float32, 64, "nchw", True),
    ("wider", 256, 128, 3, 1, None, torch.float32, 64, "nchw", True),
    ("bf16", 128, 128, 3, 1, None, torch.bfloat16, 64, "nchw", False),
    ("int8", 128, 128, 3, 1, "int8", torch.float32, 64, "nchw", False),
    ("int8_static", 128, 128, 3, 1, "int8_static", torch.float32, 64, "nchw", False),
    ("stride2", 128, 128, 3, 2, None, torch.float32, 64, "nchw", False),
    ("1x1", 128, 128, 1, 1, None, torch.float32, 64, "nchw", False),
    ("to_joints", 128, 14, 3, 1, None, torch.float32, 64, "nchw", False),
    ("resblock", 64, 64, 3, 1, None, torch.float32, 64, "nchw", False),
    ("stem", 64, 128, 3, 1, None, torch.float32, 128, "nchw", False),
    ("rows_32", 128, 128, 3, 1, None, torch.float32, 32, "nchw", False),
    ("channels_last", 128, 128, 3, 1, None, torch.float32, 64, "nhwc", False),
])
def test_the_rule_by_shape(case, cin, cout, k, stride, quant, dtype, side, layout, taken):
    """The rule's cases one by one: dtype, quantization, stride, kernel,
    channels, row width and layout each keep ``F.conv2d`` on their own."""
    conv = _conv(cin, cout, k, stride, quant)
    x = torch.empty(1, cin, side, side, dtype=dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    assert (conv.hand_f32 and cuda_conv.takes(x)) == taken


def test_an_odd_number_of_rows_keeps_f_conv2d():
    """The kernel's blocks take two rows: an odd height keeps ``F.conv2d``."""
    assert not cuda_conv.takes(torch.empty(1, 128, 63, 64))


def test_the_cpu_conv_is_f_conv2d_bit_for_bit():
    """On the CPU a conv that takes the operator runs ``F.conv2d``: its
    output and its gradients (dx, dw, db, through the operator's backward,
    ATen's ``convolution_backward``) equal native autograd's bit for bit,
    and no kernel is launched."""
    conv = _conv(128, 128)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 128, 64, 64, generator=g, requires_grad=True)
    grad = torch.randn(2, 128, 64, 64, generator=g)
    before = cuda_conv.LAUNCHES
    y = conv(x)
    want = F.conv2d(x, conv.weight, conv.bias, 1, 1)
    assert cuda_conv.LAUNCHES == before
    assert torch.equal(y, want)
    leaves = (x, conv.weight, conv.bias)
    for a, b in zip(torch.autograd.grad(y, leaves, grad), torch.autograd.grad(want, leaves, grad)):
        assert torch.equal(a, b)


def test_the_operator_gives_no_gradient_it_is_not_asked_for():
    """Only the inputs that require grad get one (autograd's mask)."""
    conv = _conv(128, 128)
    x = torch.randn(1, 128, 64, 64)
    (dw,) = torch.autograd.grad(conv(x).sum(), [conv.weight])
    assert dw.shape == conv.weight.shape and x.grad is None


def test_the_operators_fake_shapes():
    """The fake implementation (what ``torch.export`` traces) gives
    ``[B, K, H, W]`` f32 without touching data."""
    x, w, b = torch.randn(3, 128, 8, 64), torch.randn(256, 128, 3, 3), torch.randn(256)
    with FakeTensorMode() as mode:
        y = torch.ops.pwr.conv3x3_f32(*(mode.from_tensor(t) for t in (x, w, b)))
    assert y.shape == (3, 256, 8, 64) and y.dtype == torch.float32


def test_an_exported_f32_artifact_holds_the_operator(tmp_path):
    """A full-width f32 NYU Predictor exported on the CPU holds twelve
    ``pwr.conv3x3_f32`` nodes (the heads' convs, which the program runs
    through the kernel on the card) and answers as the live Predictor does,
    bit for bit."""
    torch.manual_seed(3)
    state = PixelwiseRegression(14, stage=2, features=128, level=4).state_dict()
    pred = Predictor.from_state_dict(state, "NYU", "cpu", batch_size=1)
    path = str(tmp_path / "nyu.pwrsrv")
    export_artifact(pred, path)
    art = ServingArtifact.load(path)
    nodes = [n for n in art._program.graph.nodes if n.op == "call_function"]
    assert sum(n.target is torch.ops.pwr.conv3x3_f32.default for n in nodes) == 12
    frame = np.full((1, 480, 640), 0.0)
    frame[0, 200:280, 280:360] = 500.0
    com = np.array([[320.0, 240.0, 500.0]])
    assert np.array_equal(art.predict(frame, com)["uvd"], pred.predict(frame, com)["uvd"])


def test_the_benchmark_reads_the_kernels_device_ms_a_step(monkeypatch):
    """``conv3x3_ms.train``: the traced window's conv kernels' device time
    over its train steps; 0 where no conv launched the kernel; None without
    a step or a trace."""
    from port_bench import harness

    reader = harness.metric_reader("conv3x3_ms.train")
    steps = [obs.Span("train.step", i, None, i, 1, 0, 1) for i in (1, 2)]
    record = {"trace": {"kernels": {
        "(anonymous namespace)::conv3x3_f32_kernel(float const*, float const*)": [0.036, 24],
        "void at::native::elementwise_kernel": [0.1, 400]}}}
    monkeypatch.setattr(obs, "spans", lambda: list(steps))
    assert reader.read(record) == pytest.approx(18.0, rel=1e-12)
    assert reader.read({"trace": {"kernels": {}}}) == 0.0
    assert reader.read({}) is None
    monkeypatch.setattr(obs, "spans", lambda: [])
    assert reader.read(record) is None
