"""V2V-PoseNet (Moon, Chang and Lee, CVPR 2018, arXiv 1711.07399): a
voxel-to-voxel 3D CNN from an occupancy grid to one 3D heatmap a joint.

Built as the PyTorch reimplementation reads the paper's Figs. 4-5
(github.com/dragonbook/V2V-PoseNet-pytorch, ``src/v2v_model.py``), with its
module names, so that its state dicts load here:

* ``Basic(k)``: conv3d k^3 (padding k // 2), BatchNorm3d, ReLU;
* ``Res(a -> b)``: ``relu(BN(conv3^3(relu(BN(conv3^3 x)))) + skip)``, where
  ``skip`` is ``x``, or ``BN(conv1^3 x)`` when ``a != b``;
* ``Pool``: max-pool 2^3, stride 2; ``Up(a -> b)``: ConvTranspose3d 2^3,
  stride 2, BatchNorm3d, ReLU.

Front: ``Basic7(1 -> 16)`` at the input side, ``Pool``, three ``Res`` to 32
channels. Encoder-decoder: ``s1 = Res(32, 32)``; ``Pool``, ``Res(32, 64)``,
``s2 = Res(64, 64)``; ``Pool``, ``Res(64, 128)``, ``Res(128, 128)`` (mid),
``Res(128, 128)``; ``Up(128, 64) + s2``, ``Res(64, 64)``; ``Up(64, 32) +
s1``. Back: ``Res(32, 32)``, ``Basic1(32, 32)`` twice, conv1^3 to the joints.
The input ``[B, 1, S, S, S]`` gives ``[B, J, S/2, S/2, S/2]``; S a multiple
of 8. BatchNorm3d normalises with the batch's statistics in train mode, as
published. The published initialisation: every conv's weight N(0, 0.001),
its bias 0. Float32: the model runs in the precision of its weights, with
TF32 off where a train state is made (``core.precision``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Basic3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv3d(cin, cout, k, padding=k // 2),
                                   nn.BatchNorm3d(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.block(x)


class Res3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(cin, cout, 3, padding=1), nn.BatchNorm3d(cout), nn.ReLU(inplace=True),
            nn.Conv3d(cout, cout, 3, padding=1), nn.BatchNorm3d(cout))
        self.skip_con = (nn.Sequential() if cin == cout else
                         nn.Sequential(nn.Conv3d(cin, cout, 1), nn.BatchNorm3d(cout)))

    def forward(self, x):
        return F.relu(self.res_branch(x) + self.skip_con(x), inplace=True)


class Pool3DBlock(nn.Module):
    def forward(self, x):
        return F.max_pool3d(x, 2, 2)


class Upsample3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(nn.ConvTranspose3d(cin, cout, 2, stride=2),
                                   nn.BatchNorm3d(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.block(x)


class EncoderDecorder(nn.Module):
    """The hourglass at the output side (the reimplementation's spelling)."""

    def __init__(self):
        super().__init__()
        self.encoder_pool1 = Pool3DBlock()
        self.encoder_res1 = Res3DBlock(32, 64)
        self.encoder_pool2 = Pool3DBlock()
        self.encoder_res2 = Res3DBlock(64, 128)
        self.mid_res = Res3DBlock(128, 128)
        self.decoder_res2 = Res3DBlock(128, 128)
        self.decoder_upsample2 = Upsample3DBlock(128, 64)
        self.decoder_res1 = Res3DBlock(64, 64)
        self.decoder_upsample1 = Upsample3DBlock(64, 32)
        self.skip_res1 = Res3DBlock(32, 32)
        self.skip_res2 = Res3DBlock(64, 64)

    def forward(self, x):
        s1 = self.skip_res1(x)
        x = self.encoder_res1(self.encoder_pool1(x))
        s2 = self.skip_res2(x)
        x = self.encoder_res2(self.encoder_pool2(x))
        x = self.decoder_res2(self.mid_res(x))
        x = self.decoder_res1(self.decoder_upsample2(x) + s2)
        return self.decoder_upsample1(x) + s1


class V2VPoseNet(nn.Module):
    def __init__(self, joints: int, in_size: int = 88):
        super().__init__()
        if in_size % 8:
            raise ValueError(f"the input side must be a multiple of 8, got {in_size}")
        self.joints, self.in_size = joints, in_size
        self.front_layers = nn.Sequential(
            Basic3DBlock(1, 16, 7), Pool3DBlock(), Res3DBlock(16, 32), Res3DBlock(32, 32),
            Res3DBlock(32, 32))
        self.encoder_decoder = EncoderDecorder()
        self.back_layers = nn.Sequential(
            Res3DBlock(32, 32), Basic3DBlock(32, 32, 1), Basic3DBlock(32, 32, 1))
        self.output_layer = nn.Conv3d(32, joints, 1)
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                nn.init.normal_(m.weight, 0.0, 0.001)
                nn.init.zeros_(m.bias)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """``[B, 1, S, S, S]`` occupancy -> ``[B, J, S/2, S/2, S/2]`` heatmaps."""
        x = self.back_layers(self.encoder_decoder(self.front_layers(grid)))
        return self.output_layer(x)
