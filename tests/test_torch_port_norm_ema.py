"""The anchored instance norm's train-mode EMA update (``models/layers.
InstanceNorm``): its anchors equal, bit for bit, those of the update that
made its momentum a float32 tensor on the input's device at every call,
and the train-mode forward of an anchored model makes no tensor from a host
value on the input's device (on a card each such tensor is a copy from
pageable memory, which PyTorch follows with a stream synchronise).

The file imports neither jax nor the JAX package, so its ``cuda`` cases
also run on a machine without jax:

    python -m pytest tests/test_torch_port_norm_ema.py -q -m cuda --noconftest
"""

import pytest
import torch
from torch.overrides import TorchFunctionMode

from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.layers import InstanceNorm, _InstanceNormFn
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.parallel import mesh

from torch_port_threads import one_thread  # noqa: F401 (autouse)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def _batch_mean(mean):
    return mesh.global_mean(mean.sum(dim=(0, 2, 3), dtype=torch.float64),
                            mean.shape[0]).to(torch.float32)


def _tensor_momentum_update(anchor, batch_mean):
    """The EMA update with its momentum a float32 tensor made on the
    device at each call, ``m * anchor + (1 - m) * batch_mean``: the form
    the Python-float factors must equal bit for bit."""
    m = torch.tensor(0.9, dtype=torch.float32, device=anchor.device)
    return m * anchor + (1.0 - m) * batch_mean


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_anchor_ema_equals_the_tensor_momentum_update_bit_for_bit(device, dtype):
    """Four train-mode forwards from anchor_n = 0 on [2, 4, 8, 8] inputs
    whose channel means lie far from zero (300, -250, 1000) and one
    near-constant channel (40 +- 1e-3): after each, the anchors and
    anchor_n equal the tensor-momentum update of the same per-(B, C) means,
    and y the forward's with the anchor from before the update. The update
    with 0.1 in place of 1.0f - 0.9f = 0.10000002f parts from it on these
    inputs, so the test sees the constant."""
    dev = _device(device)
    gen = torch.Generator().manual_seed(20)
    norm = InstanceNorm(4, "instance_anchored").to(dev).train()
    with torch.no_grad():
        norm.weight.copy_(torch.tensor([1.5, 0.5, 1.0, 2.0]))
        norm.bias.copy_(torch.tensor([0.1, -0.2, 0.0, 0.3]))
    centre = torch.tensor([300.0, -250.0, 1000.0, 40.0])[None, :, None, None]
    spread = torch.tensor([20.0, 5.0, 50.0, 1e-3])[None, :, None, None]
    parted = False
    for _ in range(4):
        x = (centre + spread * torch.randn(2, 4, 8, 8, generator=gen)).to(dev, dtype)
        anchor, n = norm.anchor.clone(), norm.anchor_n.clone()
        debias = 1.0 - torch.pow(0.9, n)
        c = torch.where(debias > 0, anchor / torch.clamp_min(debias, 1e-12), 0.0)
        with torch.no_grad():
            y_want, mean = _InstanceNormFn.apply(x, norm.weight, norm.bias, c,
                                                 "instance_anchored", norm.eps)
            y = norm(x)
        batch_mean = _batch_mean(mean)
        want = _tensor_momentum_update(anchor, batch_mean)
        assert torch.equal(norm.anchor, want)
        assert float(norm.anchor_n) == float(n) + 1.0
        assert torch.equal(y, y_want.to(dtype))
        parted |= not torch.equal(anchor * 0.9 + batch_mean * 0.1, want)
    assert parted


def _host_value_to(device_type):
    """A TorchFunctionMode that counts the calls that make a tensor on a
    ``device_type`` device from a host value: ``torch.tensor`` and
    ``torch.as_tensor`` given such a device, ``Tensor.to`` of a CPU tensor
    to one, and ``Tensor.copy_`` from a CPU tensor into one. It also counts
    every ``copy_``, to show that it sees the norms' updates."""

    def on(d):
        return d is not None and torch.device(d).type == device_type

    def to_target(args, kwargs):
        for a in (*args[1:], kwargs.get("device")):
            if isinstance(a, torch.Tensor):
                return a.device
            if isinstance(a, (str, torch.device)):
                return a
        return None

    class Count(TorchFunctionMode):
        host_values = 0
        copies = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in (torch.tensor, torch.as_tensor):
                self.host_values += on(kwargs.get("device"))
            elif func is torch.Tensor.to:
                self.host_values += args[0].device.type == "cpu" and on(to_target(args, kwargs))
            elif func is torch.Tensor.copy_:
                self.copies += 1
                self.host_values += args[1].device.type == "cpu" and on(args[0].device)
            return func(*args, **kwargs)

    return Count()


@pytest.mark.parametrize("family", ["pixelwise", "fullreg"])
def test_train_forward_makes_no_tensor_from_a_host_value(family):
    """A small anchored PixelwiseRegression (two stages, 16 features, level
    2) and FullRegression, in train mode, forward on the meta device: there
    a tensor made from a host value is a move from the CPU that the mode
    sees (on the CPU such a move is a no-op). None is made, and every
    anchored norm's update is seen."""
    if family == "pixelwise":
        model = PixelwiseRegression(5, stage=2, features=16, level=2,
                                    norm_method="instance_anchored", decoder="torch")
    else:
        model = FullRegression(5, stage=2, label_size=32, features=16, level=2,
                               norm_method="instance_anchored")
    model = model.to("meta").train()
    norms = sum(isinstance(m, InstanceNorm) for m in model.modules())
    img = torch.empty(2, 1, 64, 64, device="meta")
    label_img = torch.empty(2, 1, 32, 32, device="meta")
    with _host_value_to("meta") as count:
        model(img, label_img, torch.empty(2, 1, 32, 32, device="meta"))
    assert norms > 0 and count.copies >= norms
    assert count.host_values == 0
