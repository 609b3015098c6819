"""Vision models: ResNet-50 and the MNIST CNN, the counterpart of
``tpu_on_k8s/models/vision.py``.

``BatchNorm``, ``Conv``, ``Dense``, ``Bottleneck``, ``ResNetConfig``
(``resnet50``, ``resnet18ish``), ``ResNet``, ``MnistCNN`` and
``vision_partition_rules``, as ``nn.Module``s. Each model takes the
reference's NHWC images ``[B, H, W, C]`` and returns fp32 logits
``[B, classes]``; ``train=True`` normalises with the batch's statistics
and updates the running averages, as the reference's
``apply(..., train=True, mutable=["batch_stats"])`` does.

Layout: the images are read as the NCHW view of their NHWC memory
(``permute(0, 3, 1, 2)``), which is ``channels_last`` already, so cuDNN runs
NHWC convolutions on the tensor cores with no copy. A ``Conv`` weight is
``[out, in, kh, kw]``, the reference's HWIO ``kernel`` transposed; a
``Dense`` weight is ``[out, in]``. ``MnistCNN`` flattens the NHWC view, the
reference's (h, w, c) order, so ``dense1``'s rows carry across as they are.

What flax computes and PyTorch's own modules do not:

* ``padding="SAME"`` puts the odd pixel after, not around: at stride 2 on
  an even size a 3x3 window pads (0, 1), where PyTorch's ``padding=1``
  pads (1, 1). ``same_pads`` computes flax's pads; an asymmetric pair is
  applied with ``F.pad`` (``-inf`` for the stem's max pool).
* ``BatchNorm`` is flax's: statistics in fp32 with the fast variance
  ``E[x²] − E[x]²`` clipped at 0; the running averages
  ``0.9·ra + 0.1·batch`` with the biased variance (``nn.BatchNorm2d``
  updates with the unbiased one); eps 1e-5. Its training call is
  ``_BatchNormTrain``, an ``autograd.Function`` that saves x, the mean and
  the inverse std (not the fp32 copies plain autograd would keep) and
  computes its backward from two per-channel sums. ``batch_norm_plain`` is
  the same function in plain autograd, its twin in the tests.
* Compute is ``dtype`` (bf16) and parameters fp32; each BatchNorm runs in
  fp32 and casts back; the pooling before the head is an fp32 mean and the
  head an fp32 ``Dense``.

On a mesh the reference's statistics cover the global batch sharded over
(data, fsdp): XLA inserts the reduction. Here ``sync_batch_stats`` hands
every ``BatchNorm`` the process groups of those axes; a training call sums
its per-channel sums and sums of squares over them (every rank holds as
many rows), and its backward the two per-channel gradient sums. The running averages then
agree on every rank, and FSDP2 leaves them replicated. A ``seq`` axis
splits nothing of an image (the reference's ``data_sharding``): the models
have no ``split_sequence``, every rank of the axis holds the same rows,
and the statistics are summed over (data, fsdp) alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpu_on_k8s_torch.parallel.mesh import AXIS_FSDP
from tpu_on_k8s_torch.parallel.partition import PartitionRule

MOMENTUM = 0.9
EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (and XLA's) ``"SAME"`` padding of one spatial dim: the output
    is ``ceil(size / stride)``, the total pad the least that gives it, the
    odd pixel after (``lax.padtype_to_pads``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad2d(x: torch.Tensor, pads, value: float = 0.0):
    """``x`` NCHW with ``pads`` ((top, bottom), (left, right)) applied: a
    symmetric pair is returned as a padding argument (no copy), an
    asymmetric one padded here."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, window, stride, padding="SAME")``: pads of -inf."""
    pads = [same_pads(x.shape[d], window, stride) for d in (2, 3)]
    x, padding = _pad2d(x, pads, -math.inf)
    return F.max_pool2d(x, window, stride, padding)


class Conv(nn.Module):
    """flax's ``nn.Conv`` on NCHW tensors: the input and the weight cast to
    ``dtype``, ``padding`` "SAME" (``same_pads``, per call) or explicit
    ((top, bottom), (left, right)), the bias added after the product."""

    def __init__(self, n_in: int, n_out: int, kernel: int, stride: int = 1,
                 padding="SAME", bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(n_out, n_in, kernel, kernel,
                                               dtype=param_dtype))
        self.bias = (nn.Parameter(torch.empty(n_out, dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = (self.padding if self.padding != "SAME" else
                [same_pads(x.shape[d], self.kernel, self.stride)
                 for d in (2, 3)])
        x, padding = _pad2d(x.to(self.dtype), pads)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride,
                     padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x`` and the weight ``[out, in]`` cast to
    ``dtype``, the bias added after the product."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(n_out, n_in,
                                               dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(n_out, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.linear(x.to(self.dtype), self.weight.to(self.dtype))
                + self.bias.to(self.dtype))


def _channel_sums(x32: torch.Tensor, *others: torch.Tensor):
    """Per-channel sums over (N, H, W) of ``x32`` and each of ``others``."""
    return [t.sum(dim=(0, 2, 3)) for t in (x32, *others)]


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        dist.all_reduce(t, group=group)
    return t


def _batch_stats(x: torch.Tensor, groups=()):
    """(mean, biased variance, count) per channel of NCHW ``x`` in fp32,
    flax's ``_compute_stats`` with the fast variance, over the batch of
    every rank of ``groups``."""
    x32 = x.float()
    s1, s2 = _channel_sums(x32, x32.square())
    n = x.numel() // x.shape[1]
    if groups:
        # every rank holds as many rows (``batch_sharding``)
        c = s1.shape[0]
        both = _all_reduce(torch.cat([s1, s2]), groups)
        s1, s2 = both[:c], both[c:]
        n *= math.prod(dist.get_world_size(g) for g in groups)
    mean, mean2 = s1 / n, s2 / n
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return mean, var, n


def _normalize(x: torch.Tensor, mean, var, scale, bias, eps: float):
    """flax's ``_normalize``: ``(x − mean) · (rsqrt(var + eps) · scale) +
    bias`` in fp32, per channel of NCHW ``x``."""
    mul = torch.rsqrt(var + eps) * scale
    return (x.float() - mean[:, None, None]) * mul[:, None, None] + \
        bias[:, None, None]


class _BatchNormTrain(torch.autograd.Function):
    """A training call of ``BatchNorm``: normalise NCHW ``x`` with the
    batch's statistics and cast to ``dtype``; returns (y, mean, var). It
    saves x, the mean and the inverse std; the backward recomputes
    x̂ = (x − mean)·r and, from the two per-channel sums Σdy and Σdy·x̂
    (summed over ``groups``: the global batch), gives
    dx = scale·r/N · (N·dy − Σdy − x̂·Σdy·x̂), dscale = Σdy·x̂ and
    dbias = Σdy of this rank's rows (FSDP2 sums those over the ranks)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, dtype, groups):
        mean, var, n = _batch_stats(x, groups)
        r = torch.rsqrt(var + eps)
        y = _normalize(x, mean, var, scale.float(), bias.float(), eps)
        ctx.save_for_backward(x, mean, r, scale)
        ctx.n, ctx.groups = n, groups
        ctx.mark_non_differentiable(mean, var)
        return y.to(dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, mean, r, scale = ctx.saved_tensors
        dy = dy.float()
        xhat = (x.float() - mean[:, None, None]) * r[:, None, None]
        sdy, sdyx = _channel_sums(dy, dy * xhat)
        dscale, dbias = sdyx.to(scale.dtype), sdy.to(scale.dtype)
        if ctx.groups:
            c = sdy.shape[0]
            both = _all_reduce(torch.cat([sdy, sdyx]), ctx.groups)
            sdy, sdyx = both[:c], both[c:]
        n = ctx.n
        k = (scale.float() * r / n)[:, None, None]
        dx = k * (n * dy - sdy[:, None, None] - xhat * sdyx[:, None, None])
        return dx.to(x.dtype), dscale, dbias, None, None, None


def batch_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float, dtype: torch.dtype):
    """``_BatchNormTrain`` on one rank in plain autograd (every fp32
    intermediate saved): its twin in the tests. Returns (y, mean, var)."""
    mean, var, _ = _batch_stats(x)
    return (_normalize(x, mean, var, scale.float(), bias.float(),
                       eps).to(dtype), mean.detach(), var.detach())


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
    over the channels of NCHW tensors (see the module docstring), its
    output cast to ``dtype``. Parameters ``scale`` and ``bias`` and
    buffers ``mean`` and ``var`` (the reference's ``batch_stats``) are
    fp32. ``zero_scale`` starts the scale at 0 (the reference's ``bn3``).
    ``groups``: the process groups a training call's statistics are summed
    over (``sync_batch_stats``)."""

    groups: tuple = ()

    def __init__(self, features: int, dtype: torch.dtype,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(features, dtype=torch.float32))
        self.register_buffer("mean", torch.empty(features,
                                                 dtype=torch.float32))
        self.register_buffer("var", torch.empty(features,
                                                dtype=torch.float32))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return _normalize(x, self.mean, self.var, self.scale.float(),
                              self.bias.float(), EPS).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias, EPS,
                                             self.dtype, self.groups)
        with torch.no_grad():
            self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        return y


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck, ``features`` wide, 4x out, with a
    projection shortcut when the width or the stride changes the shape."""

    def __init__(self, n_in: int, features: int, strides: int,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        out = features * 4

        def conv(a, b, k, s=1):
            return Conv(a, b, k, s, dtype=dtype, param_dtype=param_dtype)

        self.conv1 = conv(n_in, features, 1)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = conv(features, features, 3, strides)
        self.bn2 = BatchNorm(features, dtype)
        self.conv3 = conv(features, out, 1)
        self.bn3 = BatchNorm(out, dtype, zero_scale=True)
        if n_in != out or strides > 1:
            self.proj_conv = conv(n_in, out, 1, strides)
            self.proj_bn = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if hasattr(self, "proj_conv"):
            x = self.proj_bn(self.proj_conv(x), train)
        return F.relu(y + x)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """The reference's config, with ``torch.dtype``s."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def resnet50(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(num_classes=num_classes)

    @staticmethod
    def resnet18ish(num_classes: int = 10) -> "ResNetConfig":
        """Small test shape (still bottleneck blocks)."""
        return ResNetConfig(stage_sizes=(1, 1), num_classes=num_classes,
                            width=16)


class ResNet(nn.Module):
    """ResNet-v1.5 with bottleneck blocks: ``forward(images [B, H, W, C],
    train=False)`` → ``[B, num_classes]`` fp32 logits. The blocks are
    ``stage{s}_block{b}`` (the reference's names); ``blocks`` lists them,
    the units FSDP2 shards."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.conv_init = Conv(3, cfg.width, 7, 2, ((3, 3), (3, 3)),
                              dtype=dt, param_dtype=pdt)
        self.bn_init = BatchNorm(cfg.width, dt)
        self._block_names: List[str] = []
        n_in = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                features = cfg.width * 2 ** stage
                setattr(self, name, Bottleneck(n_in, features, strides, dt,
                                               pdt))
                self._block_names.append(name)
                n_in = features * 4
        self.head = Dense(n_in, cfg.num_classes, torch.float32, pdt)

    @property
    def blocks(self) -> List[Bottleneck]:
        return [getattr(self, name) for name in self._block_names]

    def tensor_parallel(self, tp_mesh) -> None:
        """What ``shard_model`` does over a ``model`` axis > 1: nothing.
        The rules name no ``model`` axis, so every rank of it holds whole
        weights, as in the reference."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.float().mean(dim=(2, 3)))   # global avg pool


class MnistCNN(nn.Module):
    """The reference's config/samples MNIST shape: 2 convs + 2 dense, on
    ``[B, 28, 28, 1]`` images."""

    blocks: Sequence[nn.Module] = ()

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(1, 32, 3, bias=True, dtype=dtype)
        self.conv2 = Conv(32, 64, 3, bias=True, dtype=dtype)
        self.dense1 = Dense(7 * 7 * 64, 128, dtype)
        self.head = Dense(128, num_classes, torch.float32)

    tensor_parallel = ResNet.tensor_parallel

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        return self.head(F.relu(self.dense1(x)))


def vision_partition_rules() -> List[PartitionRule]:
    """The reference's rules on the port's ``[out, in, kh, kw]`` and
    ``[out, in]`` layouts: conv weights put fsdp on the output channels
    (dim 0), ``head`` on its input (dim 1), ``dense*`` on its output (dim
    0); norms, biases and scales are replicated. No rule names ``model``:
    over a model axis the weights are whole on every rank."""
    return [
        PartitionRule(r"bn|norm|bias|scale", ()),
        PartitionRule(r"head\.weight", (None, AXIS_FSDP)),
        PartitionRule(r"conv.*\.weight", (AXIS_FSDP,)),
        PartitionRule(r"dense.*\.weight", (AXIS_FSDP,)),
    ]


def sync_batch_stats(model: nn.Module, groups) -> None:
    """Sum every ``BatchNorm``'s training statistics over the process
    ``groups`` (the mesh's batch axes; empty: this rank's batch alone)."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.groups = tuple(groups)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init ``lecun_normal`` on a port weight (``[out,
    in, ...]``: fan in = in x the window): a normal truncated at ±2 standard
    deviations, scaled to variance 1 / fan in, drawn in fp32 by inverting
    the normal CDF of a uniform, as ``jax.random.truncated_normal``."""
    fan_in = math.prod(shape[1:])
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    z = torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1) * math.sqrt(2)
    # the truncated normal's std is 0.8796 of the untruncated one
    return z.clamp(-2, 2) * (math.sqrt(1 / fan_in) / .87962566103423978)


def init_variables(model: nn.Module, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of a vision model as the reference's
    ``model.init`` makes them: ``lecun_normal`` weights, zero biases, unit
    BatchNorm scales (zero where ``zero_scale``), zero means and unit
    variances. Drawn on ``generator``'s device in the state dict's order,
    each in the dtype the model holds it in. Load with
    ``params.load_module``."""
    out = {}
    for prefix, module in model.named_modules():
        p = f"{prefix}." if prefix else ""
        for name, t in (*module.named_parameters(recurse=False),
                        *module.named_buffers(recurse=False)):
            if name == "weight":
                v = lecun_normal(t.shape, generator)
            elif name in ("scale", "var"):
                fill = 0.0 if getattr(module, "zero_scale", False) and (
                    name == "scale") else 1.0
                v = torch.full(t.shape, fill, device=generator.device)
            else:
                v = torch.zeros(t.shape, device=generator.device)
            out[p + name] = v.to(t.dtype)
    return out
