"""DiT, the diffusion transformer (port of ``paddle_tpu/models/dit.py``,
BASELINE config 4), written on the port's paddle surface: patchify as a
``nn.Linear``, adaLN-Zero blocks over timestep and class conditioning,
q/k/v and the MLP as the tensor-parallel layers, attention through
``F.scaled_dot_product_attention`` (the flash kernels: no mask, no
dropout), and the DDPM schedule with the DDIM sampler.

Names, shapes and initializers are the JAX model's. Its weights are
paddle's ``[in, out]``; the ``nn.Linear`` ones keep that layout here and
the tensor-parallel ones (each block's ``qkv``, ``proj``, ``fc1``,
``fc2``) hold torch's ``[out, in]``, which ``models/convert.py``'s
``dit_state_from_numpy`` transposes. The layers are made on the expected
place (``framework.place``: the card unless ``set_device("cpu")``).

Dtypes follow the JAX package: ``dtype="bfloat16"`` casts the parameters
and the sin-cos buffer, but the timestep embedding is fp32 and so are the
inputs a caller passes, and every product promotes (``ops.linalg``'s
``linear_out_in``), so every activation after the first product is fp32
and attention runs in fp32 at head dim ``hidden / heads`` (72 at XL/2:
the CUDA-core flash kernels).

Every random draw of this module (the training timesteps and noise, the
sampler's x_T and its eta noise, the label drops of classifier-free
guidance) goes through :func:`draw` with the generator it should take
(``None``: torch's default one for the device), so a test can put other
draws in its place. Inside a captured ``jit.TrainStep`` the default CUDA
generator is registered with the graph by torch, so each replay draws
fresh t, noise and drops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import nn
from ..distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                   RowParallelLinear)
from ..framework.place import current_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.functional.common import drawing_generator

__all__ = ["DiTConfig", "DiT", "DiTBlock", "TimestepEmbedder",
           "LabelEmbedder", "GaussianDiffusion", "draw", "dit_param_count",
           "dit_flops_per_image"]


@dataclass
class DiTConfig:
    """DiT-XL/2 at the ImageNet-256 latent by default (Peebles & Xie 2023,
    Table 1: 28 layers, hidden 1152, 16 heads, patch 2, 32 x 32 x 4
    latents)."""
    input_size: int = 32          # latent H = W
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = False
    dtype: str = "float32"

    @staticmethod
    def dit_xl_2(**overrides):
        return DiTConfig(**{**dict(hidden_size=1152, num_hidden_layers=28,
                                   num_attention_heads=16, patch_size=2),
                            **overrides})

    @staticmethod
    def dit_b_4(**overrides):
        return DiTConfig(**{**dict(hidden_size=768, num_hidden_layers=12,
                                   num_attention_heads=12, patch_size=4),
                            **overrides})

    @staticmethod
    def tiny(**overrides):
        return DiTConfig(**{**dict(input_size=8, patch_size=2, in_channels=3,
                                   hidden_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, num_classes=10),
                            **overrides})


def draw(kind: str, shape, generator: Optional[torch.Generator], device,
         high: Optional[int] = None) -> torch.Tensor:
    """One random draw of this module on ``device`` from ``generator``
    (``None``: torch's default one there): ``"t"`` int64 timesteps in
    ``[0, high)``; ``"label_drop"`` fp32 uniforms in ``[0, 1)``;
    ``"noise"``, ``"x_T"``, ``"eta"`` fp32 standard normals."""
    g = drawing_generator(generator, device)
    shape = tuple(int(s) for s in shape)
    if kind == "t":
        return torch.randint(0, int(high), shape, generator=g, device=device)
    if kind == "label_drop":
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float32)
    if kind in ("noise", "x_T", "eta"):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32)
    raise ValueError(f"draw: unknown kind {kind!r}")


def _sincos_pos_embed_2d(dim, grid_size):
    """Fixed 2D sin-cos positional table [grid*grid, dim] (the DiT recipe;
    a copy of the JAX package's numpy code), fp32."""
    assert dim % 4 == 0, "hidden_size must be divisible by 4 for 2D sin-cos"
    quarter = dim // 4
    omega = 1.0 / (10000 ** (np.arange(quarter, dtype=np.float64) / quarter))
    pos = np.arange(grid_size, dtype=np.float64)
    out = np.einsum("p,q->pq", pos, omega)  # [grid, dim/4]
    emb_1d = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    emb_h = np.repeat(emb_1d[:, None, :], grid_size, axis=1)
    emb_w = np.repeat(emb_1d[None, :, :], grid_size, axis=0)
    full = np.concatenate([emb_h, emb_w], axis=-1)  # [grid, grid, dim]
    return full.reshape(grid_size * grid_size, dim).astype(np.float32)


def _timestep_embed(t, dim, max_period=10000):
    """[cos(t f), sin(t f)] with f_i = exp(-ln(max_period) i / half), in
    fp32 whatever the model's dtype (the JAX ``dit_timestep_embed``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(nn.Layer):
    def __init__(self, hidden_size, freq_dim=256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(nn.Linear(freq_dim, hidden_size), nn.Silu(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t):
        return self.mlp(_timestep_embed(t, self.freq_dim, 10000))


class LabelEmbedder(nn.Layer):
    """Class embedding with classifier-free-guidance dropout: in training
    each label is replaced by the null class (the table's extra row) with
    probability ``dropout_prob``, drawn from ``generator`` (``None``:
    torch's default one for the labels' device)."""

    def __init__(self, num_classes, hidden_size, dropout_prob,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.generator = generator
        self.table = nn.Embedding(num_classes + 1, hidden_size)

    @property
    def dropout_p(self):
        """The drop rate under the name ``jit.TrainStep`` looks for when it
        registers a layer's own generator with its graph."""
        return self.dropout_prob

    def forward(self, labels):
        if self.training and self.dropout_prob > 0:
            u = draw("label_drop", (labels.shape[0],), self.generator,
                     labels.device)
            labels = torch.where(u < self.dropout_prob, self.num_classes,
                                 labels.long())
        return self.table(labels)


def _zero_attr():
    return nn.ParamAttr(initializer=I.Constant(0.0))


class DiTBlock(nn.Layer):
    """adaLN-Zero block: the conditioning regresses per-branch shift,
    scale and gate; ``ada`` starts at zero, so a fresh block is the
    identity."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        h = config.hidden_size
        dev = current_device()
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.norm1 = nn.LayerNorm(h, epsilon=1e-6, weight_attr=False,
                                  bias_attr=False)
        self.qkv = ColumnParallelLinear(h, 3 * h, has_bias=True,
                                        gather_output=False, device=dev)
        self.proj = RowParallelLinear(h, h, has_bias=True,
                                      input_is_parallel=True, device=dev)
        self.norm2 = nn.LayerNorm(h, epsilon=1e-6, weight_attr=False,
                                  bias_attr=False)
        mlp_h = int(h * config.mlp_ratio)
        self.fc1 = ColumnParallelLinear(h, mlp_h, has_bias=True,
                                        gather_output=False, device=dev)
        self.fc2 = RowParallelLinear(mlp_h, h, has_bias=True,
                                     input_is_parallel=True, device=dev)
        self.ada = nn.Linear(h, 6 * h, weight_attr=_zero_attr(),
                             bias_attr=_zero_attr())

    def forward(self, x, cond):
        b, s = x.shape[0], x.shape[1]
        mod = self.ada(F.silu(cond))  # [b, 6h]
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
        h1 = self.norm1(x) * (1.0 + sc1[:, None]) + sh1[:, None]
        qkv = self.qkv(h1).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=False)
        x = x + g1[:, None] * self.proj(attn.reshape(b, s, -1))
        h2 = self.norm2(x) * (1.0 + sc2[:, None]) + sh2[:, None]
        mlp = self.fc2(F.gelu(self.fc1(h2), approximate=True))
        return x + g2[:, None] * mlp


class DiT(nn.Layer):
    """The noise-prediction network eps_theta(x_t, t, y)."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        self.config = config
        c = config
        if c.learn_sigma:
            raise NotImplementedError(
                "learn_sigma needs the VLB variance objective, which "
                "GaussianDiffusion.training_loss does not provide yet; train "
                "with the eps-prediction objective (learn_sigma=False)")
        self.out_channels = c.in_channels
        self.num_patches = (c.input_size // c.patch_size) ** 2
        patch_dim = c.patch_size * c.patch_size * c.in_channels
        self.patch_proj = nn.Linear(patch_dim, c.hidden_size)
        grid = c.input_size // c.patch_size
        self.register_buffer(
            "pos_embed", torch.tensor(_sincos_pos_embed_2d(
                c.hidden_size, grid)[None], device=current_device()),
            persistable=False)
        self.t_embed = TimestepEmbedder(c.hidden_size)
        self.y_embed = LabelEmbedder(c.num_classes, c.hidden_size,
                                     c.class_dropout_prob)
        self.blocks = nn.LayerList([DiTBlock(c)
                                    for _ in range(c.num_hidden_layers)])
        self.final_norm = nn.LayerNorm(c.hidden_size, epsilon=1e-6,
                                       weight_attr=False, bias_attr=False)
        self.final_ada = nn.Linear(c.hidden_size, 2 * c.hidden_size,
                                   weight_attr=_zero_attr(),
                                   bias_attr=_zero_attr())
        self.final_proj = nn.Linear(
            c.hidden_size, c.patch_size * c.patch_size * self.out_channels,
            weight_attr=_zero_attr(), bias_attr=_zero_attr())
        if c.dtype == "bfloat16":
            self.to(dtype="bfloat16")

    def _patchify(self, x):
        c = self.config
        p = c.patch_size
        g = c.input_size // p
        x = x.reshape(x.shape[0], c.in_channels, g, p, g, p)
        x = x.permute(0, 2, 4, 3, 5, 1)  # b, g, g, p, p, C
        return x.reshape(x.shape[0], g * g, p * p * c.in_channels)

    def _unpatchify(self, x):
        c = self.config
        p = c.patch_size
        g = c.input_size // p
        x = x.reshape(x.shape[0], g, g, p, p, self.out_channels)
        x = x.permute(0, 5, 1, 3, 2, 4)
        return x.reshape(x.shape[0], self.out_channels, g * p, g * p)

    def forward(self, x, t, y):
        h = self.patch_proj(self._patchify(x)) + self.pos_embed
        cond = self.t_embed(t) + self.y_embed(y)
        for block in self.blocks:
            h = block(h, cond)
        shift, scale = torch.chunk(self.final_ada(F.silu(cond)), 2, dim=-1)
        h = self.final_norm(h) * (1.0 + scale[:, None]) + shift[:, None]
        return self._unpatchify(self.final_proj(h))


class GaussianDiffusion:
    """The DDPM schedule, the noise-prediction loss and the DDIM sampler
    (the PaddleMIX pipeline's role)."""

    def __init__(self, num_timesteps=1000, beta_start=1e-4, beta_end=0.02):
        self.T = num_timesteps
        betas = np.linspace(beta_start, beta_end, num_timesteps,
                            dtype=np.float32)
        alphas = 1.0 - betas
        self._alphas_bar_np = np.cumprod(alphas)  # host copy: the sampler's
        self.betas = torch.from_numpy(betas)
        self.alphas_bar = torch.from_numpy(self._alphas_bar_np.copy())
        self._on = {}  # device -> alphas_bar there (made before a capture)

    def _table(self, device):
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = self.alphas_bar.to(device)
        return self._on[key]

    def q_sample(self, x0, t, noise):
        """The forward process: x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps."""
        ab = self._table(x0.device)[t.long()]
        ab = ab.reshape((-1,) + (1,) * (x0.dim() - 1))
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def training_loss(self, model, x0, y, t=None, noise=None,
                      generator: Optional[torch.Generator] = None):
        """The noise-prediction MSE (the DiT objective); t and the noise
        are drawn from ``generator`` when not given."""
        b = x0.shape[0]
        if t is None:
            t = draw("t", (b,), generator, x0.device, high=self.T)
        if noise is None:
            noise = draw("noise", tuple(x0.shape), generator, x0.device)
        x_t = self.q_sample(x0, t, noise)
        pred = model(x_t, t, y)
        return F.mse_loss(pred, noise)

    def ddim_sample(self, model, shape, y, steps=50, eta=0.0, seed=0):
        """The DDIM loop on the model's device: x_T and the eta noise from
        a torch generator seeded with ``seed`` (the JAX package draws them
        from ``jax.random.key(seed)``), the model in eval mode (no label
        drop), no autograd. eta 0 is deterministic; eta 1 is DDPM's
        ancestral sampling."""
        dev = next(iter(model.parameters())).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        x = draw("x_T", shape, gen, dev)
        ts = np.linspace(self.T - 1, 0, steps).astype(np.int64)
        was_training = getattr(model, "training", False)
        if was_training:
            model.eval()
        try:
            with torch.no_grad():
                for i, t_host in enumerate(ts):
                    t = torch.full((shape[0],), int(t_host),
                                   dtype=torch.int64, device=dev)
                    eps = model(x, t, y)
                    ab_t = float(self._alphas_bar_np[int(t_host)])
                    ab_prev = float(self._alphas_bar_np[int(ts[i + 1])]) \
                        if i + 1 < len(ts) else 1.0
                    x0_pred = (x - float(math.sqrt(1 - ab_t)) * eps) \
                        / float(math.sqrt(ab_t))
                    sigma = eta * math.sqrt((1 - ab_prev) / (1 - ab_t)) \
                        * math.sqrt(1 - ab_t / ab_prev) if i + 1 < len(ts) \
                        else 0.0
                    dir_coef = math.sqrt(max(1 - ab_prev - sigma ** 2, 0.0))
                    x = float(math.sqrt(ab_prev)) * x0_pred \
                        + float(dir_coef) * eps
                    if sigma > 0:
                        x = x + float(sigma) * draw("eta", shape, gen, dev)
        finally:
            if was_training:
                model.train()
        return x


def dit_param_count(config: DiTConfig) -> int:
    """Parameters of ``DiT(config)``."""
    h, L = config.hidden_size, config.num_hidden_layers
    p, c = config.patch_size, config.in_channels
    mlp = int(h * config.mlp_ratio)
    block = (3 * h * h + 3 * h) + (h * h + h) + (h * mlp + mlp) + \
        (mlp * h + h) + (6 * h * h + 6 * h)
    return (p * p * c * h + h) + (256 * h + h + h * h + h) + \
        (config.num_classes + 1) * h + L * block + \
        (2 * h * h + 2 * h) + (h * p * p * c + p * p * c)


def dit_flops_per_image(config: DiTConfig) -> float:
    """Training FLOPs an image, as ``bench.py``'s DiT row counts them:
    tokens x (6 N + 12 L h tokens)."""
    tokens = (config.input_size // config.patch_size) ** 2
    return tokens * (6 * dit_param_count(config) + 12 *
                     config.num_hidden_layers * config.hidden_size * tokens)
