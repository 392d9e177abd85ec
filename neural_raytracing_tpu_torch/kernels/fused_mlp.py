"""K1, K6 and K7: the fused Fourier-encode + SkipConnMLP forward and its
backward, CUDA kernels for Hopper.

K1 replaces the TPU kernel ``neural_raytracing_tpu/kernels/fused_mlp.py``
(``_pallas_forward``, body ``_build_kernel``), bound by the f32 FMA rate.
It has two routes, chosen by the net's shape before the launch
(``k1_route``): a net with ``in_size`` 3, ``hidden_size`` <= 256,
``freqs`` <= 128 and at most 32 layers (every fused net the port builds)
takes the tile (``csrc/fused_mlp_tile.cu`` over the register and
tensor-core tiles of ``csrc/mlp_tiled.cuh`` that K2-K4 use), any other the
first kernel (``csrc/fused_mlp.cu`` over the device MLP of
``csrc/mlp.cuh``, 32 points a block).  The tile reads the weights packed
once per net and weight version (``tile_pack``: one launch of
``pack_tile_weights``, cached for the module; K2-K4 read their shift net
from the same cache) and evaluates 64 rows a block: the whole tile at
``hidden_size`` > 128, half of the 128-row tile below, whose two blocks a
SM finish the path's launches sooner.  Both routes give the same float32
bits.  Its plain version is ``SkipConnMLP.forward`` (``nn/mlp.py``).

K1-bf16 (``fused_mlp_forward_bf16``) is K1 for a net with
``compute_dtype=torch.bfloat16``, the JAX ``_build_kernel`` with
``compute_dtype=bfloat16``: every matmul operand is rounded to bf16 (the
encoding, ``act(enc)`` of the float32 encoding on the skip layers, every
``act(h)``, the weight matrices), the products accumulate in float32, and
``x @ B``, sin/cos and the biases stay float32.  The tile runs its products
on the tensor cores (``mma.sync``), over the weights the pack casts; the
first kernel over the ``NRT_BF16_MLP`` operands of ``csrc/mlp.cuh``, with
the weight matrices cast once per call.  Its plain version is
``mlp_forward_bf16_operands``.  The product of two bf16 values is exact in
float32, so kernel and plain version differ by float32 sums in another
order (and by a bf16 rounding that such a difference tips over).

K6 (``fused_mlp_backward``, replacing ``_pallas_backward``) and K7
(``fused_mlp_ckpt_forward`` + ``fused_mlp_segment_backward``, replacing the
two kernels of ``_pallas_backward_segmented``) are the hand-written backward:
recompute the forward, backprop every layer, dW/db summed over the rows,
dx through the Fourier chain; dB = 0.  They are first-order only and take
K1's routes: a net on the tile runs ``csrc/fused_mlp_bwd_tile.cu`` (K1's
forward that stores the pre-activations, the gradient chain on the same
register tile over the transposed weights ``pack_tile_transposes`` writes
once per net and version, cached beside the module as K1's pack is, and
one grouped dW launch whose rows split into the fixed slices of
``dw_plan``, added in slice order: the same dW bits from run to run); a
net off it the three kernels of ``csrc/fused_mlp_bwd.cu`` over
``csrc/mlp.cuh`` (dW by atomics).  Their plain versions are
``mlp_backward_plain`` (K6), ``ckpt_forward_plain`` and
``segment_backward_plain`` (K7), the same math in PyTorch ops, and the
autograd recompute of ``_FusedMLP.backward``; ``tile_backward_plain``
computes K6's and K7's function from the two packs alone.

Gradients: ``fused_mlp_apply`` wraps K1 in an ``autograd.Function``.  By
default its backward recomputes through the plain version, as the JAX
``_bwd`` does: the render differentiates the SDF shift net for its normals,
and a backward built from plain ops can itself be differentiated
(grad-of-grad for the eikonal loss).  ``FusedSkipConnMLP(kernel_bwd=True)``
takes K6 (``kernel_bwd_segments`` 0 or 1) or K7 (2 or more) instead, for
nets that are never differentiated twice (the shading nets); the JAX
options are ``pallas_bwd`` and ``pallas_bwd_segments``.

``FusedSkipConnMLP(mode=...)`` selects the path: "auto" launches the kernel
for CUDA tensors and takes the plain version for CPU tensors, "force"
launches the kernel and raises on CPU tensors, "off" is the plain version.
A latent input always takes the plain version.  With bf16 operands the CPU
path in "auto" is the kernel's autograd.Function with K1-bf16's plain
version in the kernel's place (the JAX ``mode="force"``), and "off" the
module's own forward (the JAX "off"), which computes the whole Fourier
encoding in bf16 (``B`` cast, ``x @ B`` and sin/cos rounded) and the layers
in float32.  Either way the default backward recomputes through that
bf16-encoding forward, as the JAX ``_bwd`` does, so the gradient is not that
of the function the K1-bf16 forward computed; the port keeps this.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..nn.mlp import ACTIVATION_GRADS, SkipConnMLP, check_compute_dtype, mlp_forward
from ..ops.encoding import fourier_encode
from ._build import library

MAX_LAYERS = 32   # NRT_MAX_LAYERS in csrc/mlp.cuh
# activation codes of csrc/mlp.cuh
ACT_CODES = {"leaky_relu": 0, "relu": 1, "softplus": 2, "sigmoid": 3,
             "tanh": 4, "elu": 5, "identity": 6}

_I, _P = ctypes.c_int, ctypes.c_void_p
_NET = [_I] * 8   # n, in_size, freqs, hidden, num_layers, skip, out_size, act


def _lib() -> ctypes.CDLL:
    lib = library("fused_mlp")
    lib.nrt_fused_mlp_forward.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _P, _P]
    lib.nrt_fused_mlp_forward.restype = _I
    return lib


def _tile_lib() -> ctypes.CDLL:
    lib = library("fused_mlp_tile")
    lib.nrt_mlp_tile_forward.argtypes = [_P, _P, *_NET, _I, _P, _P]
    lib.nrt_mlp_tile_info.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.nrt_mlp_tile_pack.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
    for fn in (lib.nrt_mlp_tile_forward, lib.nrt_mlp_tile_info, lib.nrt_mlp_tile_pack):
        fn.restype = _I
    return lib


def check_cuda_f32(name: str, t: torch.Tensor, shape=None, device=None,
                   dtype=torch.float32):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` (float32 unless given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def operand_weights(weights, compute_dtype):
    """The weights (``flat_weights`` order) as a kernel with
    ``compute_dtype`` operands reads them: for bf16 the matrices cast once,
    in one cast of their concatenation (the JAX ``_mlp_weight_arrays``),
    the biases as they are."""
    if check_compute_dtype(compute_dtype) == torch.float32:
        return list(weights)
    mats = [w.detach() for w in weights[0::2]]
    flat = torch.cat([w.reshape(-1) for w in mats]).to(compute_dtype)
    out, offset = list(weights), 0
    for i, w in enumerate(mats):
        out[2 * i] = flat[offset:offset + w.numel()].view(w.shape)
        offset += w.numel()
    return out


def weight_shapes(mlp: SkipConnMLP) -> list:
    """The shapes of ``[B, init_w, init_b, layer_w, layer_b, ..., out_w,
    out_b]``, the kernels' order."""
    H = mlp.hidden_size
    shapes = [(mlp.in_size, mlp.freqs), (mlp.enc_size, H), (H,)]
    for i in range(mlp.num_layers):
        shapes += [(mlp.skip_size if mlp.is_skip_layer(i) else H, H), (H,)]
    return shapes + [(H, mlp.out_size), (mlp.out_size,)]


def check_weights(mlp: SkipConnMLP, basis: torch.Tensor, weights,
                  device: torch.device, compute_dtype=torch.float32) -> list:
    """Raise unless the net's tensors are contiguous CUDA tensors on
    ``device`` of their shapes, the matrices of ``compute_dtype`` and
    everything else float32 -> them in kernel order ``[B, init_w, init_b,
    layer_w, layer_b, ..., out_w, out_b]``."""
    if mlp.latent_size:
        raise ValueError("the fused MLP kernel takes no latent input")
    if mlp.num_layers > MAX_LAYERS:
        raise ValueError(f"the fused MLP kernel takes at most {MAX_LAYERS} "
                         f"layers, got {mlp.num_layers}")
    shapes = weight_shapes(mlp)
    tensors = [basis, *weights]
    if len(tensors) != len(shapes):
        raise ValueError(f"expected {len(shapes)} weight tensors, got {len(tensors)}")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        dtype = compute_dtype if i % 2 == 1 else torch.float32   # the matrices
        check_cuda_f32(f"weight {i}", t, shape, device, dtype)
    return tensors


def weight_pointers(mlp: SkipConnMLP, basis: torch.Tensor, weights,
                    device: torch.device, compute_dtype=torch.float32):
    """``check_weights``, then the tensors' addresses in kernel order as a
    C pointer table."""
    tensors = check_weights(mlp, basis, weights, device, compute_dtype)
    return (_P * len(tensors))(*(t.data_ptr() for t in tensors))


# ---- K1's routes ----------------------------------------------------------------

# the nets the tile takes (csrc/fused_mlp_tile.cu, csrc/mlp_tiled.cuh)
TILE_LIMITS = {"in_size": 3, "hidden_size": 256, "freqs": 128, "num_layers": MAX_LAYERS}
ROUTES = ("tile", "general")


def k1_route(mlp: SkipConnMLP) -> str:
    """The K1 kernel ``mlp`` takes, by its shape: "tile" within
    ``TILE_LIMITS``, else "general" (the first kernel, whose C entry
    refuses a net past the block's shared memory).  Raises ValueError,
    before anything touches a device, for a net neither takes: a latent or
    more than ``MAX_LAYERS`` layers."""
    if mlp.latent_size:
        raise ValueError("the fused MLP kernel takes no latent input")
    if mlp.num_layers > MAX_LAYERS:
        raise ValueError(f"the fused MLP kernel takes at most {MAX_LAYERS} "
                         f"layers, got {mlp.num_layers}")
    if (mlp.in_size == TILE_LIMITS["in_size"]
            and all(getattr(mlp, k) <= v for k, v in TILE_LIMITS.items() if k != "in_size")):
        return "tile"
    return "general"


def _pick_route(name: str, mlp: SkipConnMLP, route) -> str:
    """``route`` (``k1_route(mlp)``'s when None), refused where the tile
    does not take the net."""
    chosen = k1_route(mlp)
    route = chosen if route is None else route
    if route not in ROUTES or (route == "tile" and chosen != "tile"):
        raise ValueError(f"{name}: route {route!r} does not take this net "
                         f"(its route is {chosen!r})")
    return route


def fused_mlp_forward(mlp: SkipConnMLP, x: torch.Tensor, basis: torch.Tensor,
                      weights, compute_dtype=torch.float32, *, route=None) -> torch.Tensor:
    """Launch K1: ``x [n, in_size] -> [n, out]`` on CUDA tensors, with
    float32 or (K1-bf16, counted as ``fused_mlp_forward_bf16``) bf16
    operands, through ``k1_route(mlp)``'s kernel.

    ``weights`` are in ``SkipConnMLP.flat_weights`` order, float32 on
    ``x``'s device.  For measuring, ``route="general"`` runs the first
    kernel on a tile net.  Launches on the current stream and does not
    synchronise.
    """
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    route = _pick_route("fused_mlp_forward", mlp, route)
    n = x.shape[0]
    check_cuda_f32("x", x, (n, mlp.in_size))
    out = torch.empty(n, mlp.out_size, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    net = _net_args(mlp, n)
    with torch.cuda.device(x.device):
        if route == "tile":
            ptrs = tile_pointers(mlp, basis, weights, x.device, compute_dtype)
            rc = _tile_lib().nrt_mlp_tile_forward(
                x.data_ptr(), out.data_ptr(), *net, int(bf16), ptrs, stream)
        else:
            weights = operand_weights(weights, compute_dtype)   # alive until the launch
            ptrs = weight_pointers(mlp, basis, weights, x.device, compute_dtype)
            rc = _lib().nrt_fused_mlp_forward(
                x.data_ptr(), out.data_ptr(), *net, int(bf16), ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_forward: CUDA error {rc} at launch")
    if n > 0:
        wrapper = fused_mlp_forward_bf16 if bf16 else fused_mlp_forward
        wrapper.launches += 1
        wrapper.route_launches[route] += 1
    return out


def fused_mlp_forward_bf16(mlp: SkipConnMLP, x: torch.Tensor,
                           basis: torch.Tensor, weights, **kw) -> torch.Tensor:
    """Launch K1-bf16: ``fused_mlp_forward`` with bf16 operands."""
    return fused_mlp_forward(mlp, x, basis, weights, torch.bfloat16, **kw)


fused_mlp_forward.launches = 0
fused_mlp_forward_bf16.launches = 0
# launches by route ("tile", "general"); launches is their sum
fused_mlp_forward.route_launches = dict.fromkeys(ROUTES, 0)
fused_mlp_forward_bf16.route_launches = dict.fromkeys(ROUTES, 0)


# ---- the tile's weights: layout, pack, cache -------------------------------------

def tile_widths(mlp: SkipConnMLP, compute_dtype=torch.float32):
    """``(NP, EP)``: the padded hidden width (128 or 256) and encoding width
    (a multiple of 8, or 16 with bf16 operands) of the tile's packed layout
    (``csrc/mlp_tiled.cuh``; K2-K4's shift net has the same)."""
    r = 16 if check_compute_dtype(compute_dtype) == torch.bfloat16 else 8
    return (128 if mlp.hidden_size <= 128 else 256), -(-mlp.enc_size // r) * r


def f32_column_order(np_width: int) -> torch.Tensor:
    """The logical output column of each physical column of a packed f32
    matrix (``nrt_tiled_col`` of ``csrc/mlp_tiled.cuh``)."""
    p = torch.arange(np_width)
    return (p % 64) // 4 + 16 * (4 * (p // 64) + p % 4)


def tile_layout(mlp: SkipConnMLP, compute_dtype=torch.float32):
    """The tile's packed weights as one buffer: ``([(byte offset, shape,
    dtype), ...], total bytes)`` in kernel order ``[B, init w, init b,
    layer 0 w, layer 0 b, ..., out w, out b]``, each slot 16-byte aligned.

    With ``(NP, EP) = tile_widths(mlp, compute_dtype)`` the activation
    buffer holds h at rows ``[0, NP)`` and the encoding (then ``act(enc)``)
    at ``[NP, NP + EP)``; a layer's matrix has a row for each buffer row it
    reads: the init layer the ``EP`` encoding rows, a skip layer all
    ``NP + EP``, any other layer the ``NP`` h rows.  Its weights sit in the
    rows of their inputs and in its first ``hidden_size`` columns; every
    other entry, and the biases past ``hidden_size``, are zero.
      - float32: each matrix ``[K, NP]``, its columns in the order of
        ``f32_column_order(NP)`` (physical column p holds logical column
        ``f32_column_order(NP)[p]``);
      - bfloat16: each matrix transposed, ``[NP, K]`` bf16, rounded to
        nearest even;
    biases ``[NP]`` float32 (logical order); out w ``[out_size, NP]``
    float32, k contiguous for each output column (rounded to bf16 with bf16
    operands); out b ``[out_size]``; ``B`` as the module's."""
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    NP, EP = tile_widths(mlp, compute_dtype)
    f32 = torch.float32
    slots = [((mlp.in_size, mlp.freqs), f32)]
    for l in range(mlp.num_layers + 1):
        k = EP if l == 0 else (NP + EP if mlp.is_skip_layer(l - 1) else NP)
        slots += [((NP, k), compute_dtype) if bf16 else ((k, NP), f32), ((NP,), f32)]
    slots += [((mlp.out_size, NP), f32), ((mlp.out_size,), f32)]
    layout, offset = [], 0
    for shape, dtype in slots:
        layout.append((offset, shape, dtype))
        offset += -(-int(np.prod(shape)) * dtype.itemsize // 16) * 16
    return layout, offset


def _tile_views(buf: torch.Tensor, layout) -> list:
    """The slots of ``tile_layout`` as views of the byte buffer ``buf``."""
    return [buf[off:off + int(np.prod(shape)) * dtype.itemsize].view(dtype).view(shape)
            for off, shape, dtype in layout]


@torch.no_grad()
def tile_pack_plain(mlp: SkipConnMLP, basis: torch.Tensor, weights,
                    compute_dtype=torch.float32) -> list:
    """The pack in PyTorch ops (``pack_tile_weights``' plain version): the
    views of one byte buffer on the weights' device, ``tile_layout``'s
    slots."""
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    NP, EP = tile_widths(mlp, compute_dtype)
    H, E = mlp.hidden_size, mlp.enc_size
    ws = [w.detach() for w in weights]
    layout, total = tile_layout(mlp, compute_dtype)
    buf = torch.zeros(total, dtype=torch.uint8, device=ws[0].device)
    views = _tile_views(buf, layout)
    order = f32_column_order(NP).to(buf.device)

    def matrix(view, w, h_rows: bool, enc_rows: bool):
        k_h = NP if h_rows else 0
        m = torch.zeros(k_h + (EP if enc_rows else 0), NP, device=buf.device)
        if h_rows:
            m[:H, :H] = w[:H]
        if enc_rows:
            m[k_h:k_h + E, :H] = w[H if h_rows else 0:]
        view.copy_(m.t() if bf16 else m[:, order])

    views[0].copy_(basis.detach())
    matrix(views[1], ws[0], False, True)
    for i in range(mlp.num_layers):
        matrix(views[3 + 2 * i], ws[2 + 2 * i], True, mlp.is_skip_layer(i))
    for l in range(mlp.num_layers + 1):
        views[2 + 2 * l][:H] = ws[1 + 2 * l]
    out_w = views[-2]
    out_w[:, :H] = ws[-2].t()
    if bf16:
        out_w.copy_(out_w.to(compute_dtype).float())
    views[-1].copy_(ws[-1])
    return views


def pack_tile_weights(mlp: SkipConnMLP, basis: torch.Tensor, weights,
                      compute_dtype=torch.float32, out=None) -> list:
    """Launch the pack on CUDA tensors: ``tile_pack_plain``'s views, written
    in one launch from the module's float32 arrays (``weights`` in
    ``flat_weights`` order; ``basis`` is ``B``), into ``out`` (an earlier
    pack of this net, on its device) or a new buffer.  On CPU tensors the
    plain version."""
    tensors = [basis.detach(), *(w.detach() for w in weights)]
    if not tensors[0].is_cuda:
        return tile_pack_plain(mlp, basis, weights, compute_dtype)
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    dev = tensors[0].device
    for i, (t, shape) in enumerate(zip(tensors, weight_shapes(mlp), strict=True)):
        check_cuda_f32(f"weight {i}", t, shape, dev)
    views = out
    if views is None:
        layout, total = tile_layout(mlp, compute_dtype)
        views = _tile_views(torch.empty(total, dtype=torch.uint8, device=dev), layout)
    with torch.cuda.device(dev):
        _check("nrt_mlp_tile_pack", _tile_lib().nrt_mlp_tile_pack(
            _ptr_table(tensors), _ptr_table(views), mlp.freqs, mlp.hidden_size,
            mlp.num_layers, mlp.skip, mlp.out_size, int(bf16), _stream(dev)))
    pack_tile_weights.launches += 1
    return views


pack_tile_weights.launches = 0


def tile_pack_key(basis: torch.Tensor, weights, compute_dtype) -> tuple:
    """What a cached pack is valid for: the compute dtype (or the pack's
    kind, ``"transposes"`` for the backward's) and each tensor's
    address and version (an in-place update, ``load_state_dict`` or
    ``.to()`` changes it; the cache keeps the tensors alive, so no other
    tensor takes their addresses)."""
    return (compute_dtype,) + tuple((t.data_ptr(), t._version) for t in (basis, *weights))


# module -> {kind (K1's pack: its compute dtype; the backward's transposed
# pack: "transposes"): (key, the keyed tensors, packed views, their C
# pointer table)}; beside the module, not in it, so copies and pickles of a
# module carry no pack
_TILE_PACKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached_pack(mlp: SkipConnMLP, basis: torch.Tensor, weights, kind, pack):
    """(the packed views of ``kind``, their C pointer table), cached for the
    module by ``tile_pack_key``.  A new version of the weights is packed by
    ``pack(out=...)`` into the same buffer (on the current stream, after
    every launch that read it), so a repack costs the host one launch."""
    key = tile_pack_key(basis, weights, kind)
    cache = _TILE_PACKS.setdefault(mlp, {})
    hit = cache.get(kind)
    if hit is not None and hit[0] == key:
        return hit[2], hit[3]
    reuse = hit[2] if hit is not None and hit[2][0].device == basis.device else None
    packed = pack(out=reuse)
    cache[kind] = (key, [t.detach() for t in (basis, *weights)], packed, _ptr_table(packed))
    return packed, cache[kind][3]


def _tile_pack_entry(mlp: SkipConnMLP, basis: torch.Tensor, weights, compute_dtype):
    return _cached_pack(mlp, basis, weights, compute_dtype, lambda out: pack_tile_weights(
        mlp, basis, weights, compute_dtype, out=out))


def tile_pack(mlp: SkipConnMLP, basis: torch.Tensor, weights,
              compute_dtype=torch.float32) -> list:
    """The tile's packed weights of ``mlp`` (``pack_tile_weights``), cached
    for the module by ``tile_pack_key``: an eval view packs once per net, a
    training step once per net after the optimizer's in-place update."""
    return _tile_pack_entry(mlp, basis, weights, compute_dtype)[0]


def tile_pointers(mlp: SkipConnMLP, basis: torch.Tensor, weights, device: torch.device,
                  compute_dtype=torch.float32):
    """Check the net's float32 tensors on the CUDA ``device`` (a hit of the
    cache included) -> the C pointer table of its cached pack, what the
    tile kernels K1-K4 read."""
    check_weights(mlp, basis, weights, device)
    return _tile_pack_entry(mlp, basis, weights, compute_dtype)[1]


@torch.no_grad()
def tile_forward_plain(mlp: SkipConnMLP, x: torch.Tensor, packed,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """The tile's forward in PyTorch ops over the packed arrays alone
    (``tile_layout``'s slots, ``packed``) and ``x [n, 3]``: the encoding
    and ``act(enc)`` padded to ``EP`` columns with zeros, each layer's
    product over its ``K`` rows of ``[h, act(enc)]``, the float32 columns
    put back in logical order before the bias, the output layer over the
    first ``hidden_size`` columns.  With bf16 operands every operand is
    rounded as K1-bf16 rounds it (the skip layers read ``act`` of the
    float32 encoding).  For tests of the layout: the kernel's sums run in
    another order."""
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    NP, EP = tile_widths(mlp, compute_dtype)
    H, act = mlp.hidden_size, mlp.activation
    enc = fourier_encode(x.reshape(-1, mlp.in_size), packed[0])
    pad = torch.zeros(enc.shape[0], EP - enc.shape[1], dtype=enc.dtype, device=enc.device)
    rnd = _bf16 if bf16 else (lambda t: t)
    order = f32_column_order(NP).to(enc.device)

    def layer(a, l):
        if bf16:
            return a @ packed[1 + 2 * l].float().t() + packed[2 + 2 * l]
        h = torch.empty(a.shape[0], NP, dtype=a.dtype, device=a.device)
        h[:, order] = a @ packed[1 + 2 * l]
        return h + packed[2 + 2 * l]

    skip_op = torch.cat([rnd(act(enc)), pad], dim=-1)
    h = layer(torch.cat([rnd(enc), pad], dim=-1), 0)
    for i in range(mlp.num_layers):
        a = rnd(act(h))
        h = layer(torch.cat([a, skip_op], dim=-1) if mlp.is_skip_layer(i) else a, i + 1)
    return rnd(act(h))[:, :H] @ packed[-2][:, :H].t() + packed[-1]


# ---- the tile kernel as the library reports it ------------------------------------

@functools.lru_cache(maxsize=None)
def _tile_info(bf16: bool, freqs: int, hidden: int, device: int) -> dict:
    info = (_I * 5)()
    with torch.cuda.device(device):
        rc = _tile_lib().nrt_mlp_tile_info(int(bf16), freqs, hidden, info)
    if rc != 0 or info[0] <= 0:
        raise RuntimeError(f"nrt_mlp_tile_info: CUDA error {rc}, {info[0]} blocks per SM")
    return dict(blocks_per_sm=info[0], rows=info[1], registers=info[2],
                local_bytes=info[3], smem_bytes=info[4])


def tile_info(mlp: SkipConnMLP, compute_dtype=torch.float32, device=None) -> dict:
    """The tile kernel for ``mlp`` on the CUDA ``device`` (the current one
    by default), as the library reports it: ``blocks_per_sm`` (its
    occupancy), ``rows`` a block, ``registers`` a thread, ``local_bytes``
    (local memory a thread) and ``smem_bytes`` (dynamic shared memory a
    block)."""
    if k1_route(mlp) != "tile":
        raise ValueError("tile_info: this net is off the tile")
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return _tile_info(bf16, mlp.freqs, mlp.hidden_size, index)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def mlp_forward_bf16_operands(mlp: SkipConnMLP, p: torch.Tensor,
                              basis: torch.Tensor, weights,
                              act_of_rounded_enc: bool = False) -> torch.Tensor:
    """K1-bf16's function in PyTorch ops, its plain version: every matmul
    operand rounded to bf16, float32 matmuls (exact products, float32 sums;
    keep TF32 off on the card).  The skip layers read ``act(enc)`` of the
    float32 encoding, rounded (``fused_mlp.py:82`` of the JAX package);
    ``act_of_rounded_enc=True`` takes ``act`` of the rounded encoding instead,
    the rounding of the march kernels K2-K4 (``fused_march.py:117``)."""
    batches = p.shape[:-1]
    act = mlp.activation
    enc = fourier_encode(p.reshape(-1, mlp.in_size), basis)
    if act_of_rounded_enc:
        enc = _bf16(enc)
        act_enc = _bf16(act(enc))
    else:
        act_enc = _bf16(act(enc))
        enc = _bf16(enc)
    h = enc @ _bf16(weights[0]) + weights[1]
    for i in range(mlp.num_layers):
        a = _bf16(act(h))
        if mlp.is_skip_layer(i):
            a = torch.cat([a, act_enc], dim=-1)
        h = a @ _bf16(weights[2 + 2 * i]) + weights[3 + 2 * i]
    out = _bf16(act(h)) @ _bf16(weights[-2]) + weights[-1]
    return out.reshape(batches + (mlp.out_size,))


def _k1(mlp: SkipConnMLP, x: torch.Tensor, basis: torch.Tensor, weights):
    """K1 (K1-bf16 for a bf16 net) on CUDA tensors; on CPU tensors K1-bf16's
    plain version, so the CPU computes what the card does."""
    if mlp.compute_dtype == torch.float32:
        return fused_mlp_forward(mlp, x, basis, weights)
    if not x.is_cuda:
        return mlp_forward_bf16_operands(mlp, x, basis, weights)
    return fused_mlp_forward_bf16(mlp, x, basis, weights)


def recompute_grads(plain, tensors, needs, g) -> list:
    """The backward of a kernel whose forward is ``plain(*tensors)``:
    recompute through the plain version and return the gradient against
    ``g`` of each tensor whose ``needs`` flag is set (zeros where ``plain``
    does not read it, None where not needed).  When grad mode is on (the
    caller asked for a graph of the backward) the result is differentiable."""
    create = torch.is_grad_enabled()
    inputs = [t for t, need in zip(tensors, needs) if need]
    with torch.enable_grad():
        out = plain(*tensors)
        grads = iter(torch.autograd.grad(out, inputs, g, create_graph=create,
                                         allow_unused=True))
    result = []
    for t, need in zip(tensors, needs):
        gt = next(grads) if need else None
        result.append(torch.zeros_like(t) if need and gt is None else gt)
    return result


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mlp, x, basis, *weights):
        ctx.mlp = mlp
        ctx.save_for_backward(x, basis, *weights)
        return _k1(mlp, x, basis, weights)

    @staticmethod
    def backward(ctx, g):
        def plain(x, basis, *weights):
            return mlp_forward(ctx.mlp, x, basis, weights)
        return (None, *recompute_grads(plain, ctx.saved_tensors,
                                       ctx.needs_input_grad[1:], g))


# ---- K6 / K7: the backward --------------------------------------------------

def _bwd_lib() -> ctypes.CDLL:
    lib = library("fused_mlp_bwd")
    lib.nrt_mlp_store_forward.argtypes = [_P, _P, _I, _I, _P, _P, *_NET, _P, _P]
    lib.nrt_mlp_backward_layers.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P,
                                            _P, *_NET, _P, _P]
    lib.nrt_mlp_outer.argtypes = [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I,
                                  _I, _I, _P, _P]
    for fn in (lib.nrt_mlp_store_forward, lib.nrt_mlp_backward_layers,
               lib.nrt_mlp_outer):
        fn.restype = _I
    return lib


def segment_bounds(num_layers: int, n_segments: int):
    """Contiguous hidden-layer segments ``[(l0, l1), ...]`` covering
    ``[0, num_layers)`` (the JAX ``_segment_bounds``)."""
    edges = np.linspace(0, num_layers, n_segments + 1).round().astype(int)
    return [(int(edges[s]), int(edges[s + 1]))
            for s in range(n_segments) if edges[s + 1] > edges[s]]


def _net_args(mlp: SkipConnMLP, n: int):
    return (n, mlp.in_size, mlp.freqs, mlp.hidden_size, mlp.num_layers,
            mlp.skip, mlp.out_size, ACT_CODES[mlp.activation_name])


def _ptr_table(tensors):
    return (_P * len(tensors))(*(None if t is None else t.data_ptr()
                                 for t in tensors))


def _check(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _outer(a1, act1, g, a2=None, act2=-1):
    """``[a1 | a2 | 1]^T g`` through the split-over-rows kernel:
    -> (dW [K1 + K2, N], db [N])."""
    n, k1 = a1.shape
    k2 = 0 if a2 is None else a2.shape[1]
    dst = torch.zeros(k1 + k2 + 1, g.shape[1], device=g.device)
    _check("nrt_mlp_outer", _bwd_lib().nrt_mlp_outer(
        a1.data_ptr(), a1.stride(0), k1, act1,
        None if a2 is None else a2.data_ptr(), 0 if a2 is None else a2.stride(0),
        k2, act2, 1, g.data_ptr(), g.stride(0), g.shape[1], n, dst.data_ptr(),
        _stream(g.device)))
    return dst[:-1], dst[-1]


def _layer_grads(mlp: SkipConnMLP, k: int, hs_k, enc, gh_next):
    """(dW, db) of hidden layer ``k`` from hs[k], enc and gH[k + 1]."""
    act = ACT_CODES[mlp.activation_name]
    if mlp.is_skip_layer(k):
        return _outer(hs_k, act, gh_next, enc, act)
    return _outer(hs_k, act, gh_next)


def _transposes(weights, layers):
    """``W^T`` (contiguous) of the weight slots in ``layers`` (0 = init,
    1 + i = hidden layer i, L + 1 = out), None elsewhere."""
    ws = weights[0::2]
    return [ws[i].detach().t().contiguous() if i in layers else None
            for i in range(len(ws))]


def _check_rows(mlp, x, basis, weights, rows=None, width=None):
    n = x.shape[0]
    check_cuda_f32("x", x, (n, mlp.in_size))
    if rows is not None:
        check_cuda_f32("gradient", rows, (n, width), x.device)
    return n, weight_pointers(mlp, basis, weights, x.device)


# ---- K6 / K7 on the tile: the transposed pack, the dW plan -------------------------

def _bwd_tile_lib() -> ctypes.CDLL:
    lib = library("fused_mlp_bwd_tile")
    lib.nrt_mlp_tile_store_forward.argtypes = [_P, _P, _I, _I, _P, _P, *_NET, _P, _P]
    lib.nrt_mlp_tile_backward.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, *_NET,
                                          _P, _P, _P]
    lib.nrt_mlp_tile_dw.argtypes = [_I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                                    _I, _P, _P, _P]
    lib.nrt_mlp_tile_pack_transposes.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.nrt_mlp_tile_bwd_info.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    for fn in (lib.nrt_mlp_tile_store_forward, lib.nrt_mlp_tile_backward, lib.nrt_mlp_tile_dw,
               lib.nrt_mlp_tile_pack_transposes, lib.nrt_mlp_tile_bwd_info):
        fn.restype = _I
    return lib


def tile_bwd_widths(mlp: SkipConnMLP):
    """``(NP, EPT)``: the padded hidden width of K1's tile and the encoding
    width rounded up to 64, the widths of the transposed pack's matrices
    (``csrc/fused_mlp_bwd_tile.cu``)."""
    return tile_widths(mlp)[0], -(-mlp.enc_size // 64) * 64


def tile_transpose_layout(mlp: SkipConnMLP):
    """The backward's transposed pack as one float32 buffer: ``([(float
    offset, shape) or None, ...], total floats)`` in the table order
    ``[W0T, h_0, e_0, ..., h_{L-1}, e_{L-1}]``, ``e_i`` None on a plain layer.

    With ``(NP, EPT) = tile_bwd_widths(mlp)``: ``W0T [NP, EPT]`` holds the
    init layer's ``W^T`` (row j, column e = ``init w[e, j]``), ``h_i [NP,
    NP]`` hidden layer i's h rows transposed (row j, column c = ``w[c,
    j]``), ``e_i [NP, EPT]`` a skip layer's encoding rows transposed (row j,
    column e = ``w[hidden + e, j]``); every entry past ``hidden_size`` and
    the encoding is zero.  Row j of a matrix is output column j of its
    layer: the chain's product ``gH W^T`` reads them k-row by k-row."""
    NP, EPT = tile_bwd_widths(mlp)
    shapes = [(NP, EPT)]
    for i in range(mlp.num_layers):
        shapes += [(NP, NP), (NP, EPT) if mlp.is_skip_layer(i) else None]
    layout, offset = [], 0
    for shape in shapes:
        layout.append(None if shape is None else (offset, shape))
        offset += 0 if shape is None else shape[0] * shape[1]
    return layout, offset


def _transpose_views(buf: torch.Tensor, layout) -> list:
    """The slots of ``tile_transpose_layout`` as views of ``buf``."""
    return [None if slot is None else buf[slot[0]:].view(-1)[:int(np.prod(slot[1]))].view(slot[1])
            for slot in layout]


@torch.no_grad()
def tile_transposes_plain(mlp: SkipConnMLP, weights) -> list:
    """The transposed pack in PyTorch ops (``pack_tile_transposes``' plain
    version): ``tile_transpose_layout``'s views of one float32 buffer on the
    weights' device."""
    H = mlp.hidden_size
    ws = [w.detach() for w in weights[0::2]]
    layout, total = tile_transpose_layout(mlp)
    views = _transpose_views(torch.zeros(total, device=ws[0].device), layout)
    views[0][:H, :mlp.enc_size] = ws[0].t()
    for i in range(mlp.num_layers):
        views[1 + 2 * i][:H, :H] = ws[1 + i][:H].t()
        if views[2 + 2 * i] is not None:
            views[2 + 2 * i][:H, :mlp.enc_size] = ws[1 + i][H:].t()
    return views


def pack_tile_transposes(mlp: SkipConnMLP, weights, out=None) -> list:
    """Launch the transposed pack on CUDA tensors: ``tile_transposes_plain``'s
    views, written in one launch from the module's float32 arrays
    (``weights`` in ``flat_weights`` order) into ``out`` (an earlier pack of
    this net, on its device) or a new buffer.  On CPU tensors the plain
    version."""
    mats = [w.detach() for w in weights[0::2]][:mlp.num_layers + 1]
    if not mats[0].is_cuda:
        return tile_transposes_plain(mlp, weights)
    dev = mats[0].device
    for i, (t, shape) in enumerate(zip(mats, weight_shapes(mlp)[1::2])):
        check_cuda_f32(f"weight {2 * i}", t, shape, dev)
    views = out
    if views is None:
        layout, total = tile_transpose_layout(mlp)
        views = _transpose_views(torch.empty(total, device=dev), layout)
    with torch.cuda.device(dev):
        _check("nrt_mlp_tile_pack_transposes", _bwd_tile_lib().nrt_mlp_tile_pack_transposes(
            _ptr_table(mats), _ptr_table(views), mlp.freqs, mlp.hidden_size, mlp.num_layers,
            _stream(dev)))
    pack_tile_transposes.launches += 1
    return views


pack_tile_transposes.launches = 0


def tile_transposes(mlp: SkipConnMLP, basis: torch.Tensor, weights) -> list:
    """The transposed pack of ``mlp`` (``pack_tile_transposes``), cached
    beside the module as K1's pack is (``tile_pack_key``, kind
    ``"transposes"``): a training step packs it once per net after the
    optimizer's in-place update."""
    return _transposes_entry(mlp, basis, weights)[0]


def _transposes_entry(mlp: SkipConnMLP, basis: torch.Tensor, weights):
    return _cached_pack(mlp, basis, weights, "transposes",
                        lambda out: pack_tile_transposes(mlp, weights, out=out))


def _tile_bwd_pointers(mlp: SkipConnMLP, basis: torch.Tensor, weights, device):
    """The C pointer tables of K1's f32 pack and of the transposed pack of
    the net's tensors, for a launch on the CUDA ``device``.  Where both
    cached packs hold these very tensors, unmodified (``tile_pack_key``),
    the tensors passed ``check_weights`` when they were packed, and only the
    packs' device is checked against ``device``; otherwise every tensor is
    checked before anything is packed."""
    key = tuple((t.data_ptr(), t._version) for t in (basis, *weights))
    cache = _TILE_PACKS.get(mlp, {})
    fwd, bwd = cache.get(torch.float32), cache.get("transposes")
    if (fwd is not None and bwd is not None and fwd[0][1:] == key and bwd[0][1:] == key
            and fwd[2][0].device == device == bwd[2][0].device):
        return fwd[3], bwd[3]
    check_weights(mlp, basis, weights, device)
    return (_tile_pack_entry(mlp, basis, weights, torch.float32)[1],
            _transposes_entry(mlp, basis, weights)[1])


# the dW kernel: 128 x 128 output tiles, slices of a multiple of 32 rows;
# DW_BLOCKS, the blocks a launch aims at, is 4 waves of its 2 blocks a SM
# on the 132 SMs of an H100; a slice keeps at least DW_MIN_ROWS rows
DW_TILE, DW_CHUNK, DW_BLOCKS, DW_MIN_ROWS = 128, 32, 1056, 256


def dw_plan(n: int, shapes) -> dict:
    """How the dW kernel splits a launch of layers whose outputs are
    ``shapes`` ``[(K, N), ...]`` (dW ``[K, N]``; db beside) over ``n`` rows:
    ``tiles`` (128 x 128 output tiles), ``slices`` (row slices, each summed
    by its own blocks, then added in slice order) and ``rows`` a slice.  A
    function of ``n`` and the widths alone, so the same inputs give the same
    sums."""
    tiles = sum(-(-k // DW_TILE) * -(-width // DW_TILE) for k, width in shapes)
    slices = max(1, min(DW_BLOCKS // tiles, -(-n // DW_MIN_ROWS)))
    rows = -(-(-(-max(n, 1) // slices)) // DW_CHUNK) * DW_CHUNK
    return dict(tiles=tiles, slices=max(1, -(-n // rows)), rows=rows)


def _dw_offsets(shapes):
    """Each layer's offset in the dW kernel's output (``[K + 1, N]`` each:
    dW, then db) and the total floats."""
    offsets, total = [], 0
    for k, width in shapes:
        offsets.append(total)
        total += (k + 1) * width
    return offsets, total


@torch.no_grad()
def tile_dw_plain(a: torch.Tensor, g: torch.Tensor, rows: int) -> torch.Tensor:
    """The dW kernel's function for one layer in PyTorch ops: ``[a | 1]^T g``
    (``[K + 1, N]``: dW, then db) as the sums of ``rows``-row slices added in
    slice order, as the kernel's second launch adds them."""
    a1 = torch.cat([a, a.new_ones(a.shape[0], 1)], dim=-1)
    parts = [a1[r:r + rows].t() @ g[r:r + rows] for r in range(0, a.shape[0], rows)]
    if not parts:
        return a1.new_zeros(a1.shape[1], g.shape[1])
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


@functools.lru_cache(maxsize=256)
def _dw_layout(n: int, spec: tuple):
    """What a dW launch over ``n`` rows of the layers ``spec`` ``((k1, act
    a1?, k2, act a2?, N), ...)`` needs besides its pointers: (dw_plan's
    plan, the output's floats, the C arrays of the dims and offsets, the
    outputs' shapes, the sizes that split the output into dW, db, ...)."""
    shapes = [(k1 + k2, width) for k1, _, k2, _, width in spec]
    offsets, total = _dw_offsets(shapes)
    dims = (_I * (5 * len(spec)))(*(v for job in spec for v in job))
    return (dw_plan(n, shapes), total, dims, (ctypes.c_longlong * len(spec))(*offsets),
            shapes, [v for k, width in shapes for v in (k * width, width)])


def _tile_dw(mlp: SkipConnMLP, n: int, spec, ptrs, dev) -> list:
    """Launch the dW kernel (and, with more than one slice, its reduction)
    for the layers ``spec`` (``_dw_layout``'s) whose arrays are at ``ptrs``
    ``[(a1, a2 or None, g), ...]`` -> ``[(dW, db), ...]``, views of one
    buffer."""
    plan, total, dims, offsets, shapes, sizes = _dw_layout(n, tuple(spec))
    out = torch.empty(total, device=dev)
    part = torch.empty(plan["slices"] * total, device=dev) if plan["slices"] > 1 else None
    table = lambda i: (_P * len(ptrs))(*(p[i] for p in ptrs))
    _check("nrt_mlp_tile_dw", _bwd_tile_lib().nrt_mlp_tile_dw(
        len(spec), table(0), table(1), table(2), dims, offsets, total, n, plan["slices"],
        plan["rows"], ACT_CODES[mlp.activation_name],
        None if part is None else part.data_ptr(), out.data_ptr(), _stream(dev)))
    pieces = out.split(sizes)
    return [(pieces[2 * i].view(shape), pieces[2 * i + 1]) for i, shape in enumerate(shapes)]


def _hidden_spec(mlp: SkipConnMLP, k: int) -> tuple:
    """dW of hidden layer k: A = [act(hs[k]), act(enc) on a skip layer]."""
    skip = mlp.is_skip_layer(k)
    return (mlp.hidden_size, 1, mlp.enc_size if skip else 0, int(skip), mlp.hidden_size)


def _rows_table(base: int, count: int, row_bytes: int, n: int):
    """The C table of ``count`` ``[n, row_bytes / 4]`` arrays, one after
    another from ``base``."""
    return (_P * count)(*(base + k * n * row_bytes for k in range(count)))


@functools.lru_cache(maxsize=None)
def _tile_bwd_info(freqs: int, hidden: int, out_size: int, act: int, device: int) -> dict:
    info = (_I * 12)()
    with torch.cuda.device(device):
        rc = _bwd_tile_lib().nrt_mlp_tile_bwd_info(freqs, hidden, out_size, act, info)
    if rc != 0:
        raise RuntimeError(f"nrt_mlp_tile_bwd_info: CUDA error {rc}")
    keys = ("blocks_per_sm", "registers", "local_bytes", "smem_bytes")
    return {kernel: dict(zip(keys, info[4 * i:4 * i + 4]))
            for i, kernel in enumerate(("chain", "store_forward", "dw"))}


def tile_bwd_info(mlp: SkipConnMLP, device=None) -> dict:
    """K6's and K7's tile kernels for ``mlp`` on the CUDA ``device``, as the
    library reports them: ``{"chain" | "store_forward" | "dw":
    {blocks_per_sm, registers, local_bytes, smem_bytes}}``."""
    if k1_route(mlp) != "tile":
        raise ValueError("tile_bwd_info: this net is off the tile")
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return _tile_bwd_info(mlp.freqs, mlp.hidden_size, mlp.out_size,
                          ACT_CODES[mlp.activation_name], index)


# ---- K6 / K7: the wrappers ------------------------------------------------------

def _count(wrapper, route: str, n: int):
    if n > 0:
        wrapper.launches += 1
        wrapper.route_launches[route] += 1


def fused_mlp_backward(mlp: SkipConnMLP, x: torch.Tensor, g: torch.Tensor,
                       basis: torch.Tensor, weights, *, route=None):
    """Launch K6 on CUDA tensors: the whole backward of ``out = mlp(x)`` for
    the output gradient ``g [n, out]``, through ``k1_route(mlp)``'s kernels
    (the tile: ``csrc/fused_mlp_bwd_tile.cu``; "general": those of
    ``csrc/fused_mlp_bwd.cu``, which ``route="general"`` also runs on a tile
    net, for measuring).

    Returns ``(dx [n, in], grads)`` with ``grads`` in ``flat_weights`` order.
    Launches on the current stream and does not synchronise.
    """
    route = _pick_route("fused_mlp_backward", mlp, route)
    n = x.shape[0]
    out = (_k6_tile if route == "tile" else _k6_general)(mlp, x, g, basis, weights)
    _count(fused_mlp_backward, route, n)
    return out


def _k6_tile(mlp, x, g, basis, weights):
    n = x.shape[0]
    check_cuda_f32("x", x, (n, mlp.in_size))
    check_cuda_f32("gradient", g, (n, mlp.out_size), x.device)
    L, H, E, dev = mlp.num_layers, mlp.hidden_size, mlp.enc_size, x.device
    ptrs, tptrs = _tile_bwd_pointers(mlp, basis, weights, dev)
    hs = torch.empty(L + 1, n, H, device=dev)
    enc = torch.empty(n, E, device=dev)
    hs0, enc_p = hs.data_ptr(), enc.data_ptr()
    lib, net, stream = _bwd_tile_lib(), _net_args(mlp, n), _stream(dev)
    with torch.cuda.device(dev):
        hs_ptrs = _rows_table(hs0, L + 1, 4 * H, n)
        _check("nrt_mlp_tile_store_forward", lib.nrt_mlp_tile_store_forward(
            x.data_ptr(), None, 0, L, hs_ptrs, enc_p, *net, ptrs, stream))
        # (the rest is prepared while the card runs the forward)
        gh = torch.empty(L + 1, n, H, device=dev)
        dx = torch.empty(n, mlp.in_size, device=dev)
        gh0 = gh.data_ptr()
        _check("nrt_mlp_tile_backward", lib.nrt_mlp_tile_backward(
            x.data_ptr(), g.data_ptr(), 1, 0, L, hs_ptrs, _rows_table(gh0, L + 1, 4 * H, n),
            enc_p, None, dx.data_ptr(), *net, ptrs, tptrs, stream))
        row = 4 * n * H
        spec = [(E, 0, 0, 0, H), *(_hidden_spec(mlp, k) for k in range(L)),
                (H, 1, 0, 0, mlp.out_size)]
        jobs = [(enc_p, None, gh0)]
        jobs += [(hs0 + k * row, enc_p if mlp.is_skip_layer(k) else None, gh0 + (k + 1) * row)
                 for k in range(L)]
        grads = _tile_dw(mlp, n, spec, jobs + [(hs0 + L * row, None, g.data_ptr())], dev)
    return dx, [t for pair in grads for t in pair]


def _k6_general(mlp, x, g, basis, weights):
    n, ptrs = _check_rows(mlp, x, basis, weights, g, mlp.out_size)
    L, H, dev = mlp.num_layers, mlp.hidden_size, x.device
    hs = torch.empty(L + 1, n, H, device=dev)
    gh = torch.empty(L + 1, n, H, device=dev)
    enc = torch.empty(n, mlp.enc_size, device=dev)
    dx = torch.empty(n, mlp.in_size, device=dev)
    wts = _transposes(weights, range(L + 2))
    hs_ptrs, gh_ptrs = _ptr_table(list(hs)), _ptr_table(list(gh))
    lib, net = _bwd_lib(), _net_args(mlp, n)
    with torch.cuda.device(dev):
        _check("nrt_mlp_store_forward", lib.nrt_mlp_store_forward(
            x.data_ptr(), None, 0, L, hs_ptrs, enc.data_ptr(), *net, ptrs,
            _stream(dev)))
        _check("nrt_mlp_backward_layers", lib.nrt_mlp_backward_layers(
            x.data_ptr(), g.data_ptr(), 1, 0, L, hs_ptrs, gh_ptrs,
            _ptr_table(wts), None, dx.data_ptr(), *net, ptrs, _stream(dev)))
        act = ACT_CODES[mlp.activation_name]
        grads = list(_outer(enc, -1, gh[0]))
        for k in range(L):
            grads += _layer_grads(mlp, k, hs[k], enc, gh[k + 1])
        grads += _outer(hs[L], act, g)
    return dx, grads


def fused_mlp_ckpt_forward(mlp: SkipConnMLP, x: torch.Tensor,
                           basis: torch.Tensor, weights, boundaries, *, route=None):
    """Launch K7a on CUDA tensors: the forward that keeps only the
    pre-activations ``hs[b]`` for ``b`` in ``boundaries`` (hs[0] = init
    output, hs[i + 1] = hidden layer i output), through ``k1_route(mlp)``'s
    kernel (``route`` as ``fused_mlp_backward``'s).

    Returns ``({b: hs[b] [n, H]}, enc [n, E])``; ``enc`` is the raw Fourier
    encoding the segment backward and the epilogue need.
    """
    route = _pick_route("fused_mlp_ckpt_forward", mlp, route)
    n = x.shape[0]
    if route == "tile":
        check_cuda_f32("x", x, (n, mlp.in_size))
        ptrs = _tile_bwd_pointers(mlp, basis, weights, x.device)[0]
        lib, entry = _bwd_tile_lib(), "nrt_mlp_tile_store_forward"
    else:
        n, ptrs = _check_rows(mlp, x, basis, weights)
        lib, entry = _bwd_lib(), "nrt_mlp_store_forward"
    L, dev = mlp.num_layers, x.device
    hs = {b: torch.empty(n, mlp.hidden_size, device=dev) for b in boundaries}
    enc = torch.empty(n, mlp.enc_size, device=dev)
    with torch.cuda.device(dev):
        _check(entry, getattr(lib, entry)(
            x.data_ptr(), None, 0, L, _ptr_table([hs.get(k) for k in range(L + 1)]),
            enc.data_ptr(), *_net_args(mlp, n), ptrs, _stream(dev)))
    _count(fused_mlp_ckpt_forward, route, n)
    return hs, enc


def fused_mlp_segment_backward(mlp: SkipConnMLP, x: torch.Tensor,
                               basis: torch.Tensor, weights, enc: torch.Tensor,
                               h_in: torch.Tensor, g_out: torch.Tensor,
                               l0: int, l1: int, *, route=None):
    """Launch K7b on CUDA tensors: backprop through hidden layers
    ``[l0, l1)`` from the checkpoint ``h_in = hs[l0]`` and ``g_out = gH[l1]``,
    through ``k1_route(mlp)``'s kernels (``route`` as
    ``fused_mlp_backward``'s).

    Returns ``(g_in = gH[l0], genc_act [n, E], [(dW, db) of layers l0..l1-1])``;
    ``genc_act`` is the gradient at act(enc) from the segment's skip layers.
    """
    route = _pick_route("fused_mlp_segment_backward", mlp, route)
    n = x.shape[0]
    segment = _k7b_tile if route == "tile" else _k7b_general
    out = segment(mlp, x, basis, weights, enc, h_in, g_out, l0, l1)
    _count(fused_mlp_segment_backward, route, n)
    return out


def _check_k7b(mlp, x, enc, h_in, g_out, l0, l1):
    n, H, dev = x.shape[0], mlp.hidden_size, x.device
    check_cuda_f32("x", x, (n, mlp.in_size))
    check_cuda_f32("gradient", g_out, (n, H), dev)
    check_cuda_f32("h_in", h_in, (n, H), dev)
    check_cuda_f32("enc", enc, (n, mlp.enc_size), dev)
    if not 0 <= l0 < l1 <= mlp.num_layers:
        raise ValueError(f"segment [{l0}, {l1}) is not in [0, {mlp.num_layers})")


def _k7b_rows(mlp, x, enc, h_in, g_out, l0, l1):
    """Check K7b's row tensors -> the hs and gH tables' tensors of the
    segment (hs[l0] = h_in; the inner hs and gH[l0 .. l1 - 1] new)."""
    _check_k7b(mlp, x, enc, h_in, g_out, l0, l1)
    n, L, H, dev = x.shape[0], mlp.num_layers, mlp.hidden_size, x.device
    hs: list = [None] * (L + 1)
    hs[l0] = h_in
    for k in range(l0 + 1, l1):
        hs[k] = torch.empty(n, H, device=dev)
    gh: list = [None] * (L + 1)
    for k in range(l0, l1):
        gh[k] = torch.empty(n, H, device=dev)
    return hs, gh


def _k7b_tile(mlp, x, basis, weights, enc, h_in, g_out, l0, l1):
    _check_k7b(mlp, x, enc, h_in, g_out, l0, l1)
    n, L, H, dev = x.shape[0], mlp.num_layers, mlp.hidden_size, x.device
    ptrs, tptrs = _tile_bwd_pointers(mlp, basis, weights, dev)
    inner = torch.empty(l1 - l0 - 1, n, H, device=dev)   # hs[l0 + 1 .. l1 - 1]
    gh = torch.empty(l1 - l0, n, H, device=dev)          # gH[l0 .. l1 - 1]
    genc = torch.empty(n, mlp.enc_size, device=dev)
    row = 4 * n * H
    hs_at = {l0: h_in.data_ptr(), **{k: inner.data_ptr() + (k - l0 - 1) * row
                                     for k in range(l0 + 1, l1)}}
    gh_at = {**{k: gh.data_ptr() + (k - l0) * row for k in range(l0, l1)}, l1: g_out.data_ptr()}
    table = lambda at: (_P * (L + 1))(*(at.get(k) for k in range(L + 1)))
    hs_ptrs = table(hs_at)
    lib, net, stream = _bwd_tile_lib(), _net_args(mlp, n), _stream(dev)
    with torch.cuda.device(dev):
        if l1 - l0 > 1:   # recompute hs[l0 + 1 .. l1 - 1]
            _check("nrt_mlp_tile_store_forward", lib.nrt_mlp_tile_store_forward(
                x.data_ptr(), h_in.data_ptr(), l0 + 1, l1 - 1, hs_ptrs, None, *net, ptrs,
                stream))
        _check("nrt_mlp_tile_backward", lib.nrt_mlp_tile_backward(
            x.data_ptr(), g_out.data_ptr(), 0, l0, l1, hs_ptrs,
            table({k: v for k, v in gh_at.items() if k < l1}), None, genc.data_ptr(), None,
            *net, ptrs, tptrs, stream))
        enc_p = enc.data_ptr()
        grads = _tile_dw(mlp, n, [_hidden_spec(mlp, k) for k in range(l0, l1)], [
            (hs_at[k], enc_p if mlp.is_skip_layer(k) else None, gh_at[k + 1])
            for k in range(l0, l1)], dev)
    return gh[0], genc, grads


def _k7b_general(mlp, x, basis, weights, enc, h_in, g_out, l0, l1):
    hs, gh = _k7b_rows(mlp, x, enc, h_in, g_out, l0, l1)
    n, ptrs = _check_rows(mlp, x, basis, weights)
    hs_ptrs = _ptr_table(hs)
    lib, net = _bwd_lib(), _net_args(mlp, n)
    wts = _transposes(weights, range(1 + l0, 1 + l1))
    genc = torch.empty(n, mlp.enc_size, device=x.device)
    with torch.cuda.device(x.device):
        if l1 - l0 > 1:   # recompute hs[l0 + 1 .. l1 - 1]
            _check("nrt_mlp_store_forward", lib.nrt_mlp_store_forward(
                x.data_ptr(), h_in.data_ptr(), l0, l1 - 1, hs_ptrs, None, *net,
                ptrs, _stream(x.device)))
        _check("nrt_mlp_backward_layers", lib.nrt_mlp_backward_layers(
            x.data_ptr(), g_out.data_ptr(), 0, l0, l1, hs_ptrs, _ptr_table(gh),
            _ptr_table(wts), genc.data_ptr(), None, *net, ptrs, _stream(x.device)))
        grads = [_layer_grads(mlp, k, hs[k], enc, gh[k + 1] if k + 1 < l1 else g_out)
                 for k in range(l0, l1)]
    return gh[l0], genc, grads


for _wrapper in (fused_mlp_backward, fused_mlp_ckpt_forward, fused_mlp_segment_backward):
    _wrapper.launches = 0
    # launches by route ("tile", "general"); launches is their sum
    _wrapper.route_launches = dict.fromkeys(ROUTES, 0)


# ---- the plain versions of K6 and K7 -----------------------------------------

def _plain_layers(mlp, enc, h, l0, l1, weights):
    """Forward from hs[l0] = h through hidden layers [l0, l1) ->
    ([hs[l0], ..., hs[l1]], [a_l0, ..., a_{l1-1}])."""
    act = mlp.activation
    act_enc = act(enc)
    hs, a_list = [h], []
    for i in range(l0, l1):
        a = act(hs[-1])
        if mlp.is_skip_layer(i):
            a = torch.cat([a, act_enc], dim=-1)
        a_list.append(a)
        hs.append(a @ weights[2 + 2 * i] + weights[3 + 2 * i])
    return hs, a_list


def _plain_backprop(mlp, hs, a_list, gh, l0, l1, weights):
    """Backprop gH[l1] = gh through layers [l0, l1) (``hs`` from hs[l0]) ->
    (gH[l0], genc_act, [(dW, db) of layers l0..l1-1])."""
    dact = ACTIVATION_GRADS[mlp.activation_name]
    H = mlp.hidden_size
    genc_act = torch.zeros(gh.shape[0], mlp.enc_size, dtype=gh.dtype,
                           device=gh.device)
    grads = [None] * (l1 - l0)
    for i in reversed(range(l0, l1)):
        k = i - l0
        grads[k] = (a_list[k].t() @ gh, gh.sum(0))
        ga = gh @ weights[2 + 2 * i].t()
        gh = ga[:, :H] * dact(hs[k])
        if mlp.is_skip_layer(i):
            genc_act = genc_act + ga[:, H:]
    return gh, genc_act, grads


def _plain_epilogue(mlp, x, basis, weights, enc, gh, genc_act):
    """Init layer + dx: -> (dx, d_init_w, d_init_b)."""
    dact = ACTIVATION_GRADS[mlp.activation_name]
    genc = gh @ weights[0].t() + genc_act * dact(enc)
    mapped = x @ basis
    f, i = mlp.freqs, mlp.in_size
    dx = genc[:, :i] + (genc[:, i:i + f] * torch.cos(mapped)
                        - genc[:, i + f:] * torch.sin(mapped)) @ basis.t()
    return dx, enc.t() @ gh, gh.sum(0)


@torch.no_grad()
def mlp_backward_plain(mlp: SkipConnMLP, x: torch.Tensor, g: torch.Tensor,
                       basis: torch.Tensor, weights):
    """Plain version of K6: ``(dx, grads in flat_weights order)``."""
    weights = [w.detach() for w in weights]
    basis = basis.detach()
    dact = ACTIVATION_GRADS[mlp.activation_name]
    L = mlp.num_layers
    enc = fourier_encode(x, basis)
    hs, a_list = _plain_layers(mlp, enc, enc @ weights[0] + weights[1], 0, L,
                               weights)
    d_out = (mlp.activation(hs[L]).t() @ g, g.sum(0))
    gh = (g @ weights[-2].t()) * dact(hs[L])
    gh, genc_act, layer_grads = _plain_backprop(mlp, hs, a_list, gh, 0, L, weights)
    dx, d_init_w, d_init_b = _plain_epilogue(mlp, x, basis, weights, enc, gh,
                                             genc_act)
    grads = [d_init_w, d_init_b]
    for dw, db in layer_grads:
        grads += [dw, db]
    return dx, grads + list(d_out)


@torch.no_grad()
def ckpt_forward_plain(mlp: SkipConnMLP, x: torch.Tensor, basis: torch.Tensor,
                       weights, boundaries):
    """Plain version of K7a: ``({b: hs[b]}, enc)``."""
    weights = [w.detach() for w in weights]
    enc = fourier_encode(x, basis.detach())
    hs, _ = _plain_layers(mlp, enc, enc @ weights[0] + weights[1], 0,
                          mlp.num_layers, weights)
    return {b: hs[b] for b in boundaries}, enc


@torch.no_grad()
def segment_backward_plain(mlp: SkipConnMLP, x: torch.Tensor,
                           basis: torch.Tensor, weights, enc: torch.Tensor,
                           h_in: torch.Tensor, g_out: torch.Tensor,
                           l0: int, l1: int):
    """Plain version of K7b: ``(g_in, genc_act, [(dW, db), ...])``."""
    weights = [w.detach() for w in weights]
    hs, a_list = _plain_layers(mlp, enc, h_in, l0, l1, weights)
    return _plain_backprop(mlp, hs, a_list, g_out, l0, l1, weights)


@torch.no_grad()
def tile_backward_plain(mlp: SkipConnMLP, x: torch.Tensor, g: torch.Tensor, packed,
                        transposed, segments: int = 0):
    """K6's (``segments`` 0 or 1) or K7's (2 or more) function in PyTorch ops
    over K1's float32 pack (``packed``: B, the layers, out w) and the
    transposed pack (``transposed``) alone, with the tile kernels' data
    flow: the forward keeps every pre-activation (K6) or the segments'
    boundaries, each segment recomputed from its boundary (K7); ``gH W^T``
    through the transposed matrices, padded to ``NP``/``EPT`` columns; dW
    of the layers of one launch by ``tile_dw_plain`` with the slices of
    ``dw_plan`` (K7's out layer and init layer by plain products, as
    ``segmented_backward`` runs them) -> ``(dx, grads in flat_weights
    order)``.  For tests of the layouts and the plan: the kernels' sums run
    in another order."""
    NP, EP = tile_widths(mlp)
    EPT = tile_bwd_widths(mlp)[1]
    H, E, F, L = mlp.hidden_size, mlp.enc_size, mlp.freqs, mlp.num_layers
    act, dact = mlp.activation, ACTIVATION_GRADS[mlp.activation_name]
    n = x.shape[0]
    order = f32_column_order(NP).to(x.device)
    enc = fourier_encode(x, packed[0])

    def pad(t, width):
        return torch.cat([t, t.new_zeros(t.shape[0], width - t.shape[1])], dim=-1)

    act_enc = pad(act(enc), EP)

    def forward(h, l_first, l_last):
        """Layers l_first..l_last from h = hs[l_first - 1] (None: from x)."""
        out = {}
        for l in range(l_first, l_last + 1):
            if l == 0:
                a = pad(enc, EP)
            else:
                a = act(h)
                a = torch.cat([a, act_enc], dim=-1) if mlp.is_skip_layer(l - 1) else a
            h = torch.empty(n, NP, dtype=x.dtype, device=x.device)
            h[:, order] = a @ packed[1 + 2 * l]
            h = out[l] = h + packed[2 + 2 * l]
        return out

    def dw(jobs):
        plan = dw_plan(n, [(a.shape[1], gg.shape[1]) for a, gg in jobs])
        return [tile_dw_plain(a, gg, plan["rows"]) for a, gg in jobs]

    def hidden_job(k):
        a = act(hs[k][:, :H])
        a = torch.cat([a, act(enc)], dim=-1) if mlp.is_skip_layer(k) else a
        return a, gh_at[k + 1][:, :H]

    segs = [(0, L)] if segments < 2 else segment_bounds(L, segments)
    ckpt = forward(None, 0, L)
    hs = {b: ckpt[b] for b in sorted({s0 for s0, _ in segs} | {L})}
    gh = (g @ packed[-2]) * dact(hs[L])
    gh_at, genc_act, d = {L: gh}, torch.zeros(n, EPT, dtype=x.dtype, device=x.device), {}
    for l0, l1 in reversed(segs):
        hs.update(forward(hs[l0], l0 + 1, l1 - 1))
        genc_part = torch.zeros_like(genc_act)
        for k in reversed(range(l0, l1)):
            if mlp.is_skip_layer(k):
                genc_part = genc_part + gh @ transposed[2 + 2 * k]
            gh = gh_at[k] = (gh @ transposed[1 + 2 * k]) * dact(hs[k])
        genc_act = genc_act + genc_part
        if segments >= 2:
            d.update(zip(range(l0, l1), dw([hidden_job(k) for k in range(l0, l1)])))
    out_a, gh0 = act(hs[L][:, :H]), gh_at[0][:, :H]
    if segments < 2:
        parts = dw([(enc, gh0)] + [hidden_job(k) for k in range(L)] + [(out_a, g)])
        d_init, d_out = parts[0], parts[-1]
        d.update(enumerate(parts[1:-1]))
    else:
        d_init = torch.cat([enc.t() @ gh0, gh0.sum(0, keepdim=True)])
        d_out = torch.cat([out_a.t() @ g, g.sum(0, keepdim=True)])
    genc = gh @ transposed[0] + genc_act * dact(pad(enc, EPT))
    mapped = x @ packed[0]
    dx = genc[:, :3] + (genc[:, 3:3 + F] * torch.cos(mapped)
                        - genc[:, 3 + F:E] * torch.sin(mapped)) @ packed[0].t()
    grads = []
    for m in [d_init] + [d[k] for k in range(L)] + [d_out]:
        grads += [m[:-1], m[-1]]
    return dx, grads


def segmented_backward(mlp: SkipConnMLP, x: torch.Tensor, g: torch.Tensor,
                       basis: torch.Tensor, weights, n_segments: int,
                       ckpt=None, segment=None):
    """The checkpointed backward of ``_pallas_backward_segmented``: K7a, the
    out layer in plain ops, K7b per segment (deepest first), the init layer
    and dx epilogue in plain ops.  ``ckpt``/``segment`` default to the
    kernels; the plain versions give the plain K7.  -> (dx, grads)."""
    ckpt = fused_mlp_ckpt_forward if ckpt is None else ckpt
    segment = fused_mlp_segment_backward if segment is None else segment
    weights = [w.detach() for w in weights]
    basis = basis.detach()
    L = mlp.num_layers
    dact = ACTIVATION_GRADS[mlp.activation_name]
    segs = segment_bounds(L, n_segments)
    boundaries = sorted({s[0] for s in segs} | {L})
    hs_at, enc = ckpt(mlp, x, basis, weights, boundaries)
    with torch.no_grad():
        d_out = (mlp.activation(hs_at[L]).t() @ g, g.sum(0))
        gh = ((g @ weights[-2].t()) * dact(hs_at[L])).contiguous()
        genc_act = torch.zeros_like(enc)
        d_layers: dict = {}
        for l0, l1 in reversed(segs):
            gh, genc_part, grads = segment(mlp, x, basis, weights, enc,
                                           hs_at[l0], gh, l0, l1)
            genc_act = genc_act + genc_part
            d_layers.update(zip(range(l0, l1), grads))
        dx, d_init_w, d_init_b = _plain_epilogue(mlp, x, basis, weights, enc,
                                                 gh, genc_act)
    grads = [d_init_w, d_init_b]
    for i in range(L):
        grads += list(d_layers[i])
    return dx, grads + list(d_out)


def mlp_backward(mlp: SkipConnMLP, x: torch.Tensor, g: torch.Tensor,
                 basis: torch.Tensor, weights, segments: int = 0,
                 kernel: bool = True):
    """The first-order MLP backward, ``(dx, grads in flat_weights order)``:
    K6 (``segments`` 0 or 1) or K7 (2 or more), or their plain versions
    with ``kernel=False``."""
    if segments >= 2:
        if kernel:
            return segmented_backward(mlp, x, g, basis, weights, segments)
        return segmented_backward(mlp, x, g, basis, weights, segments,
                                  ckpt_forward_plain, segment_backward_plain)
    if kernel:
        return fused_mlp_backward(mlp, x, g, basis, weights)
    return mlp_backward_plain(mlp, x, g, basis, weights)


class _FusedMLPKernelBwd(torch.autograd.Function):
    """K1 forward with the K6/K7 backward (first-order only).  The backward
    is float32 whatever the operands of the forward, as in the JAX package;
    on CPU tensors its plain versions stand in for the kernels."""

    @staticmethod
    def forward(ctx, mlp, x, basis, *weights):
        ctx.mlp = mlp
        ctx.save_for_backward(x, basis, *weights)
        return _k1(mlp, x, basis, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, basis, *weights = ctx.saved_tensors
        dx, grads = mlp_backward(ctx.mlp, x, g.contiguous(), basis, weights,
                                 segments=ctx.mlp.kernel_bwd_segments,
                                 kernel=x.is_cuda)
        needs = ctx.needs_input_grad
        return (None, dx if needs[1] else None, None,
                *(gw if need else None for gw, need in zip(grads, needs[3:])))


def fused_mlp_apply(mlp: SkipConnMLP, p: torch.Tensor) -> torch.Tensor:
    """``p [..., in_size] -> [..., out]`` through K1 (K1-bf16 for a bf16
    net), differentiable."""
    batches = p.shape[:-1]
    x = p.reshape(-1, mlp.in_size).contiguous()
    fn = _FusedMLPKernelBwd if getattr(mlp, "kernel_bwd", False) else _FusedMLP
    out = fn.apply(mlp, x, mlp.B, *mlp.flat_weights())
    return out.reshape(batches + (mlp.out_size,))


class FusedSkipConnMLP(SkipConnMLP):
    """SkipConnMLP that evaluates through K1 on CUDA tensors.

    ``mode``: "auto" (kernel for CUDA tensors, plain version for CPU ones),
    "force" (kernel; raises on CPU tensors) or "off" (plain version).
    ``kernel_bwd``: the K1 path backpropagates through K6
    (``kernel_bwd_segments`` 0 or 1) or the checkpointed K7 (2 or more)
    instead of the differentiable plain recompute; first-order only.
    ``compute_dtype=torch.bfloat16`` runs K1-bf16 (see the module
    docstring for each mode's path).
    """

    def __init__(self, *args, mode: str = "auto", kernel_bwd: bool = False,
                 kernel_bwd_segments: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in ("auto", "force", "off"):
            raise ValueError(f"mode must be 'auto', 'force' or 'off', got {mode!r}")
        self.mode = mode
        self.kernel_bwd = kernel_bwd
        self.kernel_bwd_segments = kernel_bwd_segments

    def forward(self, p: torch.Tensor, latent=None) -> torch.Tensor:
        # a custom activation callable (no registered name) runs plain, as
        # in the JAX package
        if self.mode == "off" or latent is not None or self.activation_name is None:
            return super().forward(p, latent)
        if not p.is_cuda:
            if self.mode == "force":
                raise RuntimeError("FusedSkipConnMLP(mode='force') needs CUDA "
                                   f"tensors, got one on {p.device}")
            if self.compute_dtype == torch.float32:
                return super().forward(p)
        return fused_mlp_apply(self, p)
