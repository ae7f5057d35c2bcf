"""Continuous-convolution surrogate — the port of ``nbody_tpu/models/contconv.py``
(reference ``contconv.py:10-240``).

Per layer: the ball-to-cube tanh map of each edge's displacement, trilinear
lookup into a learnable (D, D, D, ci, co) filter grid (kept in the flax
layout), the poly6 window (1 - d^2/r^2)^3 with the radius cut, and a mean or
sum over neighbours. Since interpolation and the sum are linear, a layer
collects each receiver's window- and corner-weighted features into per-cell
bins and multiplies them by the whole filter bank once.

``impl`` of :class:`ContinuousConv` (``conv_impl`` of the model):

- ``"dense"``: the collect-then-matmul layer in plain torch (the JAX
  ``"xla"`` layer), on any device, differentiable; the reference the
  kernels are held to;
- ``"kernel"``: the B3 collect kernel (``ops/contconv_kernel.py``) for CUDA
  tensors, its twin for CPU tensors. Its backward launches B4 (filters) and
  B5 (features) on the card, and B6 only when positions need a gradient;
- None (the default): ``"kernel"`` when the layer's tensors lie on a CUDA
  device, ``"dense"`` otherwise. The kernels take any k and channel widths
  and D >= 2 with D^3 <= 32767.

The JAX ``conv_geometry(tile=...)`` padding of the receiver axis exists for
the TPU's (8, 128) tiles; the port has no tile padding and takes no
``tile`` argument. ``node_chunks > 1`` (the 1M-body memory switch) runs the
kernel path one receiver chunk at a time, each chunk under
``torch.utils.checkpoint``: the backward gathers the chunk's neighbour
features again, so no (B N, k, ci) tensor outlives its chunk. Chunks are a
ceil-division of the receiver axis, the last one shorter when it does not
divide. It belongs to the kernel path: with ``impl="dense"`` it raises, and
with ``impl=None`` the layer takes the kernel path on any device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nbody_tpu_torch.models.common import gather_neighbors, select_input_features
from nbody_tpu_torch.models.mlp import MLP, OutputHead, reset_dense
from nbody_tpu_torch.ops.contconv_kernel import contconv_collect, contconv_collect_torch

DEFAULT_RADIUS_KMAX = 32  # PyG radius_graph's max_num_neighbors default
CONV_IMPLS = (None, "dense", "kernel")


def ball_to_cube(r: torch.Tensor) -> torch.Tensor:
    """Radial tanh map of displacements into the unit cube: r_unit *
    tanh(|r|), with the safe-sqrt norm sqrt(max(|r|^2, 1e-24)) so that a
    self edge (r = 0) has a finite gradient."""
    n2 = (r * r).sum(-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(n2, min=1e-24))
    return r / (norm + 1e-8) * torch.tanh(norm)


def conv_geometry(pos, nbr_idx, nbr_valid, radius, pos_src=None):
    """Per-step edge geometry shared by a stack of layers (positions are
    fixed within a model call).

    :param pos: (B, N, 3); :param nbr_idx, nbr_valid: (B, N, k).
    :param pos_src: optional (B, Ns, 3) gather source of the neighbour
        positions (``nbr_idx`` indexes it), default ``pos``. The
        particle-sharded forward passes the all-gathered positions of every
        rank here while ``pos`` holds this rank's rows.
    :return: dict with ``mapped`` (B, N, k, 3), ``window`` and ``in_radius``
        (B, N, k), ``nbr_idx``, ``n`` and ``radius``.
    """
    pos_j = gather_neighbors(pos if pos_src is None else pos_src, nbr_idx)
    r = pos_j - pos[:, :, None, :]  # neighbour - centre
    dist2 = (r * r).sum(-1)
    r2 = float(torch.tensor(float(radius), dtype=torch.float32) ** 2)  # as JAX squares it
    in_radius = (dist2 < r2) & nbr_valid.bool()
    window = torch.where(in_radius, (1.0 - dist2 / r2) ** 3, 0.0)
    return {"mapped": ball_to_cube(r), "window": window, "in_radius": in_radius,
            "nbr_idx": nbr_idx, "n": pos.shape[1], "radius": radius}


class ContinuousConv(nn.Module):
    """One continuous-convolution layer (reference ``contconv.py:10-98``).
    ``filters`` is (D, D, D, ci, co), drawn from N(0, 1) like the
    reference's ``torch.randn``; ``generator`` draws it."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_resolution: int = 4, radius: float = 0.5,
                 agg: str = "mean", impl: Optional[str] = None,
                 node_chunks: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if impl not in CONV_IMPLS:
            raise ValueError(f"unknown ContinuousConv impl {impl!r}: one of {CONV_IMPLS}")
        if node_chunks > 1 and impl == "dense":
            raise ValueError(
                f"node_chunks={node_chunks} chunks the kernel path (impl='kernel' or "
                "None); the dense layer builds its bins for all receivers at once")
        if agg not in ("mean", "sum"):
            raise ValueError(f"unknown agg {agg!r}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.filter_resolution = d = filter_resolution
        self.radius = radius
        self.agg = agg
        self.impl = impl
        self.node_chunks = node_chunks
        self.filters = nn.Parameter(torch.empty(d, d, d, in_channels, out_channels))
        with torch.no_grad():
            self.filters.normal_(generator=generator)

    def forward(self, pos, feat, nbr_idx, nbr_valid, geom=None, feat_src=None):
        """:param pos: (B, N, 3); :param feat: (B, N, ci).
        :param nbr_idx, nbr_valid: (B, N, k) padded radius neighbour lists.
        :param geom: optional shared :func:`conv_geometry`.
        :param feat_src: optional (B, Ns, ci) gather source of the neighbour
            features (``nbr_idx`` indexes it; B3's ``feat_j`` rows come from
            it), default ``feat``. The particle-sharded forward passes the
            all-gathered features of every rank here, with a ``geom`` built
            on the matching ``pos_src``, while ``pos`` and ``feat`` hold this
            rank's rows.
        :return: (B, N, co).
        """
        d = self.filter_resolution
        if geom is None:
            geom = conv_geometry(pos, nbr_idx, nbr_valid, self.radius)
        elif geom["radius"] != self.radius:
            raise ValueError("shared conv_geometry was built with a different radius")
        mapped, window, in_radius = geom["mapped"], geom["window"], geom["in_radius"]
        b, n, k = geom["nbr_idx"].shape
        ci, co = self.in_channels, self.out_channels
        grid = (mapped + 1.0) * ((d - 1) / 2.0)  # reference contconv.py:90
        filters = self.filters.reshape(d * d * d, ci, co)
        chunked = self.node_chunks > 1
        impl = self.impl or ("kernel" if feat.is_cuda or chunked else "dense")
        collect = contconv_collect if impl == "kernel" else contconv_collect_torch
        src = feat if feat_src is None else feat_src

        def rows(src, filters, grid, window, idx):
            """The collect of the receivers (B, r, ...) of one slice."""
            r = idx.shape[1]
            feat_j = gather_neighbors(src, idx).reshape(b * r, k, ci)
            planes = [grid[..., a].reshape(b * r, k).contiguous() for a in range(3)]
            return collect(*planes, window.reshape(b * r, k).contiguous(),
                           feat_j.contiguous(), filters, d=d).reshape(b, r, co)

        if chunked:
            step = -(-n // self.node_chunks)
            parts = []
            for lo in range(0, n, step):
                sl = slice(lo, lo + step)
                parts.append(checkpoint(rows, src, filters, grid[:, sl], window[:, sl],
                                        geom["nbr_idx"][:, sl], use_reentrant=False))
            out = torch.cat(parts, dim=1)
        else:
            out = rows(src, filters, grid, window, geom["nbr_idx"])
        if self.agg == "mean":  # scatter(..., reduce="mean")
            cnt = in_radius.to(out.dtype).sum(-1, keepdim=True)
            out = out / torch.clamp(cnt, min=1.0)
        return out


class ContinuousConvModel(nn.Module):
    """Constructor fields of the JAX ``ContinuousConvModel`` (reference
    ``contconv.py:102-134``). ``filter_resolution`` is an int or one value
    per layer. ``radius_impl`` and ``conv_impl`` take the port's names,
    "dense" and "kernel". ``generator`` draws the initial weights."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 3,
        filter_resolution: Union[int, Tuple[int, ...]] = (4,),
        radius: float = 0.5,
        agg: str = "mean",
        self_loops: bool = True,
        continuous_conv_layers: int = 1,
        continuous_conv_dim: int = 64,
        continuous_conv_dropout: float = 0.0,
        encoder_hiddens: Optional[Tuple[int, ...]] = None,
        encoder_dropout: float = 0.0,
        decoder_hiddens: Optional[Tuple[int, ...]] = None,
        decoder_dropout: float = 0.0,
        scale_factor: float = 1.0,
        radius_kmax: int = DEFAULT_RADIUS_KMAX,
        zero_init_output: bool = False,
        output_scale: float = 1.0,
        radius_method: Optional[str] = None,
        radius_impl: Optional[str] = None,
        conv_impl: Optional[str] = None,
        conv_node_chunks: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.filter_resolution = filter_resolution
        self.radius = radius
        self.agg = agg
        self.self_loops = self_loops
        self.continuous_conv_layers = continuous_conv_layers
        self.continuous_conv_dim = continuous_conv_dim
        self.continuous_conv_dropout = continuous_conv_dropout
        self.encoder_hiddens = encoder_hiddens
        self.encoder_dropout = encoder_dropout
        self.decoder_hiddens = decoder_hiddens
        self.decoder_dropout = decoder_dropout
        self.scale_factor = scale_factor
        self.radius_kmax = radius_kmax
        self.zero_init_output = zero_init_output
        self.output_scale = output_scale
        self.radius_method = radius_method
        self.radius_impl = radius_impl
        self.conv_impl = conv_impl
        self.conv_node_chunks = conv_node_chunks

        dim = continuous_conv_dim
        width = 4 if in_channels == 4 else 7
        self.encoder = None
        if encoder_hiddens:
            self.encoder = MLP(width, tuple(encoder_hiddens) + (dim,),
                               dropout=encoder_dropout, norm="batch_norm")
            width = dim
        enc_width = width
        self.convs = nn.ModuleList()
        for i, res in enumerate(self._resolutions()):
            ci = in_channels if (i == 0 and not encoder_hiddens) else dim
            self.convs.append(ContinuousConv(
                ci, dim, filter_resolution=res, radius=radius, agg=agg,
                impl=conv_impl, node_chunks=conv_node_chunks, generator=generator))
        self.conv_dropout = nn.Dropout(continuous_conv_dropout)
        self.norm = nn.LayerNorm(enc_width + dim, eps=1e-5)
        self.head = OutputHead(enc_width + dim, decoder_hiddens, out_channels,
                               zero_init=zero_init_output)
        if generator is not None:
            reset_dense(self, generator)

    @property
    def graph_spec(self):
        """Radius graph rebuilt from positions at every call (reference
        ``contconv.py:225``); ``radius_kmax`` mirrors PyG's
        ``max_num_neighbors=32``."""
        spec = {"radius": self.radius, "k_max": self.radius_kmax,
                "include_self": self.self_loops}
        if self.radius_method:
            spec["method"] = self.radius_method
        if self.radius_impl:
            spec["impl"] = self.radius_impl
        return ("radius", spec)

    def _resolutions(self) -> Sequence[int]:
        fr = self.filter_resolution
        if isinstance(fr, int):
            return [fr] * self.continuous_conv_layers
        if len(fr) < self.continuous_conv_layers:
            raise ValueError("fewer filter resolutions than conv layers")
        return list(fr)[:self.continuous_conv_layers]

    def forward(self, x, nbr_idx, nbr_valid, node_mask=None):
        """:param x: (B, N, 7) node features [pos | vel | mass].
        :param node_mask: optional (B, N) validity; the encoder's batch norm
            takes its training statistics over the valid nodes only.
        :return: (B, N, out_channels) predicted accelerations.
        """
        x = select_input_features(x, self.in_channels)
        pos = x[..., :3]
        if self.encoder is not None:
            x = self.encoder(x, mask=node_mask)
        encoder_output = x
        geom = conv_geometry(pos, nbr_idx, nbr_valid, self.radius)
        for conv in self.convs:
            x = self.conv_dropout(torch.tanh(conv(pos, x, nbr_idx, nbr_valid, geom=geom)))
        out = self.head(self.norm(torch.cat([encoder_output, x], dim=-1)))
        if self.output_scale != 1.0:
            out = out / self.output_scale
        return out

    def get_config(self):
        return {
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "filter_resolution": self.filter_resolution,
            "radius": self.radius,
            "agg": self.agg,
            "self_loops": self.self_loops,
            "continuous_conv_layers": self.continuous_conv_layers,
            "continuous_conv_dim": self.continuous_conv_dim,
            "continuous_conv_dropout": self.continuous_conv_dropout,
            "encoder_hiddens": self.encoder_hiddens,
            "encoder_dropout": self.encoder_dropout,
            "decoder_hiddens": self.decoder_hiddens,
            "decoder_dropout": self.decoder_dropout,
            "scale_factor": self.scale_factor,
            "radius_kmax": self.radius_kmax,
            "zero_init_output": self.zero_init_output,
            "output_scale": self.output_scale,
        }
