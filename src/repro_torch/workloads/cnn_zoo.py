"""The paper's CNN workload zoo: VGG16, ResNet18/50, MobileNet-V2, MnasNet-B1.

Each network is lowered to the chain-of-layers IR used by the fusion mapper.
Pooling is folded into the producing conv (MACs use pre-pool output dims,
the *staged* activation uses post-pool dims — that is what occupies the
on-chip buffer). Residual edges are chain annotations (``skip_src``).
Downsample/projection shortcuts in ResNets are folded into the merge layer's
weight/MAC counts so the chain stays a pure sequence (the paper's ResNet18
strategy in Fig. 4 has exactly 18 decisions).
"""
from __future__ import annotations

from .layer import Layer, Workload

__all__ = ["vgg16", "resnet18", "resnet50", "mobilenet_v2", "mnasnet_b1",
           "tiny_cnn", "CNN_ZOO", "get_workload"]


class _ChainBuilder:
    def __init__(self, name: str, c: int, y: int, x: int, batch: int = 64):
        self.name, self.c, self.y, self.x = name, c, y, x
        self.batch = batch
        self.input_elems = float(c * y * x)
        self.input_shape6 = (c, c, y, x, 1, 1)
        self.layers: list[Layer] = []

    @property
    def pos(self) -> int:
        """Chain position of the most recently added layer (0 = input)."""
        return len(self.layers)

    def conv(self, k: int, r: int = 3, stride: int = 1, groups: int = 1,
             pool: int = 1, skip_src: int = -1, extra_w: float = 0.0,
             extra_macs: float = 0.0, name: str = "conv") -> int:
        """Add a conv; returns its chain position."""
        y_out, x_out = self.y // stride, self.x // stride
        macs = float(k) * self.c * y_out * x_out * r * r / groups + extra_macs
        w = float(k) * self.c * r * r / groups + extra_w
        y_st, x_st = y_out // pool, x_out // pool  # staged (post-pool) dims
        self.layers.append(Layer(
            name=f"{name}{self.pos + 1}", K=k, C=self.c, Y=y_st, X=x_st,
            R=r, S=r, stride=stride, groups=groups, skip_src=skip_src,
            macs_override=macs, w_elems_override=w,
            out_elems_override=float(k * y_st * x_st)))
        self.c, self.y, self.x = k, y_st, x_st
        return self.pos

    def gap(self) -> None:
        """Global average pool (free op; collapses spatial dims)."""
        self.y = self.x = 1

    def fc(self, n: int, name: str = "fc") -> int:
        in_f = int(self.c * self.y * self.x)
        self.layers.append(Layer.matmul(f"{name}{self.pos + 1}", m=1, k=in_f, n=n))
        self.c, self.y, self.x = n, 1, 1
        return self.pos

    def build(self) -> Workload:
        return Workload(self.name, self.layers, self.input_elems,
                        self.input_shape6, default_batch=self.batch)


def vgg16(batch: int = 64) -> Workload:
    b = _ChainBuilder("vgg16", 3, 224, 224, batch)
    for stage, (k, reps) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]):
        for i in range(reps):
            b.conv(k, r=3, pool=2 if i == reps - 1 else 1)
    b.fc(4096); b.fc(4096); b.fc(1000)
    return b.build()


def resnet18(batch: int = 64) -> Workload:
    b = _ChainBuilder("resnet18", 3, 224, 224, batch)
    b.conv(64, r=7, stride=2, pool=2, name="stem")  # 7x7/2 + maxpool -> 56x56
    cfg = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
    for k, reps, first_stride in cfg:
        for i in range(reps):
            s = first_stride if i == 0 else 1
            src = b.pos  # block input
            downsample = s != 1 or b.c != k
            # 1x1/s projection shortcut folded into the merge conv below.
            proj_w = float(k) * b.c if downsample else 0.0
            proj_macs = proj_w * (b.y // s) * (b.x // s)
            b.conv(k, r=3, stride=s)
            b.conv(k, r=3, skip_src=src, extra_w=proj_w, extra_macs=proj_macs)
    b.gap()
    b.fc(1000)
    return b.build()


def resnet50(batch: int = 64) -> Workload:
    b = _ChainBuilder("resnet50", 3, 224, 224, batch)
    b.conv(64, r=7, stride=2, pool=2, name="stem")
    cfg = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2), (512, 2048, 3, 2)]
    for mid, out, reps, first_stride in cfg:
        for i in range(reps):
            s = first_stride if i == 0 else 1
            src = b.pos
            downsample = s != 1 or b.c != out
            proj_w = float(out) * b.c if downsample else 0.0
            proj_macs = proj_w * (b.y // s) * (b.x // s)
            b.conv(mid, r=1)
            b.conv(mid, r=3, stride=s)
            b.conv(out, r=1, skip_src=src, extra_w=proj_w, extra_macs=proj_macs)
    b.gap()
    b.fc(1000)
    return b.build()


def mobilenet_v2(batch: int = 64) -> Workload:
    b = _ChainBuilder("mobilenet_v2", 3, 224, 224, batch)
    b.conv(32, r=3, stride=2, name="stem")
    # t=1 bottleneck: dw + pw
    b.conv(32, r=3, groups=32, name="dw")
    b.conv(16, r=1, name="pw")
    cfg = [(6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, c, reps, first_stride in cfg:
        for i in range(reps):
            s = first_stride if i == 0 else 1
            src = b.pos
            residual = (s == 1 and b.c == c)
            b.conv(b.c * t, r=1, name="expand")
            b.conv(b.c, r=3, stride=s, groups=b.c, name="dw")
            b.conv(c, r=1, skip_src=src if residual else -1, name="project")
    b.conv(1280, r=1, name="head")
    b.gap()
    b.fc(1000)
    return b.build()


def mnasnet_b1(batch: int = 64) -> Workload:
    b = _ChainBuilder("mnasnet_b1", 3, 224, 224, batch)
    b.conv(32, r=3, stride=2, name="stem")
    b.conv(32, r=3, groups=32, name="dw")
    b.conv(16, r=1, name="pw")
    cfg = [(3, 24, 3, 2, 3), (3, 40, 3, 2, 5), (6, 80, 3, 2, 5),
           (6, 96, 2, 1, 3), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
    for t, c, reps, first_stride, r in cfg:
        for i in range(reps):
            s = first_stride if i == 0 else 1
            src = b.pos
            residual = (s == 1 and b.c == c)
            b.conv(b.c * t, r=1, name="expand")
            b.conv(b.c, r=r, stride=s, groups=b.c, name="dw")
            b.conv(c, r=1, skip_src=src if residual else -1, name="project")
    b.conv(1280, r=1, name="head")
    b.gap()
    b.fc(1000)
    return b.build()


def tiny_cnn(batch: int = 64) -> Workload:
    """A 6-layer VGG-style chain on 32x32 inputs — small enough that the
    whole teacher -> corpus -> train -> infer pipeline smoke-tests in
    seconds (CI training smoke job), with the same layer mix (convs with
    pooling + an FC head) the real zoo exercises."""
    b = _ChainBuilder("tiny_cnn", 3, 32, 32, batch)
    for k, reps in [(16, 2), (32, 2), (64, 1)]:
        for i in range(reps):
            b.conv(k, r=3, pool=2 if i == reps - 1 else 1)
    b.fc(64)
    return b.build()


CNN_ZOO = {
    "vgg16": vgg16,
    "resnet18": resnet18,
    "tiny_cnn": tiny_cnn,
    "resnet50": resnet50,
    "mobilenet_v2": mobilenet_v2,
    "mnasnet": mnasnet_b1,
}


def get_workload(name: str, batch: int = 64) -> Workload:
    if name not in CNN_ZOO:
        raise KeyError(f"unknown workload {name!r}; have {sorted(CNN_ZOO)}")
    return CNN_ZOO[name](batch)
