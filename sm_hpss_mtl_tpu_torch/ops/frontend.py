"""Fused audio -> HPSS front end: kernels K1 and K2 and their plain versions.

Counterpart of ``sm_hpss_mtl_tpu/ops/frontend_pallas.py::stft_hpss_mel``
(K1) and ``::stft_hpss`` (K2).  For a CUDA tensor, :func:`stft_hpss_mel`
and :func:`stft_hpss` launch the hand-written kernel of
``csrc/frontend.cu`` (windowed rDFT magnitude, harmonic and percussive
medians and soft masks in one pass, then the mel projection for K1 or the
full-resolution masked magnitudes for K2; the spectrogram never reaches
device memory), at any odd median pair of widths 3 to 61
(``median_networks.check_pair``).  Clips
shorter than ``2*(l_harm//2)`` frames (under 50 at l_harm 51) take the
JAX package's short-clip branch (``frontend_pallas._dispatch``) instead:
the plain ``stft_mag``, then the spectral kernel K4 (``hpss.hpss_mel``)
or K3 (``hpss.hpss``).  For a CPU tensor they run
:func:`stft_hpss_mel_plain` / :func:`stft_hpss_plain`, the same chain in
plain PyTorch, which call the plain HPSS (``hpss.hpss_plain``) on every
device.  A CUDA call never falls back: if a kernel cannot be built or
launched, it raises.  :func:`launch` runs K1 or K2 at any length, without
the short-clip branch (``chip_smoke.py`` holds the kernels to their plain
versions through it).

Halo mode (``halo_in_audio=True``, the JAX kernel's argument of that name):
the audio already carries ``l_harm//2`` frames of a neighbour's audio
before frame 0 and after frame ``T-1`` (``T = n_frames(N) - 2*(l_harm//2)``),
as the time-sharded front end (``parallel/frontend_shard.py``) hands each
shard.  ``edge_flags = (mirror_left, mirror_right)`` says per side whether
that audio is ignored and the symmetric edge mirror applies (1, a global
edge) or the medians read those frames as they are (0, a shard join).
Without halo both flags are 1.

Modes, as the JAX kernels take them:

- ``dft_precision``, a library of its own per precision (``_nvcc.build``).
  ``'highest'`` (the port's default): the DFT on the tensor cores in split
  TF32 (each operand a sum of two TF32 halves, three products per k-step
  of 8), close to float32, held to the JAX package's ``'highest'`` bars.
  ``'bf16x3'`` (the JAX package's default): the same products with bf16
  halves on the bf16 tensor cores, k-steps of 16.  Its plain version
  computes the same function: the fold, the operands split by
  ``Tensor.to(torch.bfloat16)``, the three products in float32.
- ``power``, a kernel argument: the masks' exponent; 2 (every feature
  family) squares, any other power goes through ``powf``.

Both precisions fold each frame into its even and odd parts (see
``csrc/frontend.cu``): :func:`dft_fragments` builds the folded windowed
basis's halves once per geometry and precision, in float64, in the order
the kernel reads them, and ``mel.mel_band_ranges`` gives K1 each mel
band's nonzero bins.  The kernels are built with ``nvcc`` at their first
launch, not at import.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _nvcc
from . import hpss as hpss_mod
from . import reference as ref
from .hpss import KERNEL_MEDIANS, hpss_plain
from .median_networks import check_pair
from .mel import _band_ranges_of
from .stft import n_frames, stft_mag
from ..utils.profiling import count

_SOURCE = "frontend.cu"
#: The DFT precisions of the JAX kernels, and so of the port's.
DFT_PRECISIONS = _nvcc.DFT_PRECISIONS


def build() -> None:
    """Build and load the kernel library of every pair of
    ``KERNEL_MEDIANS`` now (each is otherwise built at its first
    launch)."""
    for pair in KERNEL_MEDIANS:
        _nvcc.load(_SOURCE, pair)


def blocks_per_sm(*, fullres: bool, n_fft: int, hop_length: int,
                  l_harm: int, l_perc: int, dft_precision: str = "highest"
                  ) -> int:
    """Blocks of K2 (``fullres``) or K1 one SM of the current card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _nvcc.occupancy(_SOURCE, "k1_blocks_per_sm", int(fullres), n_fft,
                           hop_length, l_harm, l_perc, pair=(l_harm, l_perc),
                           dft_precision=dft_precision)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """``x`` (float64) rounded to TF32's 11 significant bits (10 stored),
    to nearest; exactly representable in float32."""
    m, e = np.frexp(np.asarray(x, dtype=np.float64))
    return np.ldexp(np.round(m * 2048.0) / 2048.0, e)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """``x`` (float64) rounded to bfloat16's 8 significant bits (7 stored),
    to nearest even; exactly representable in float32."""
    m, e = np.frexp(np.asarray(x, dtype=np.float64))
    return np.ldexp(np.round(m * 256.0) / 256.0, e)


def dft_steps(n_fft: int, win_length: int,
              dft_precision: str = "highest") -> tuple[int, int]:
    """The kernels' k-steps ``[s_lo, s_hi)`` over the folded frame, ``n``
    in ``[0, n_fft/2]``: from the window's start (``pad_center``'s
    ``lpad``; the basis is exact zeros before it) to ``n_fft/2``.  A
    k-step is 8 samples in split TF32 (``mma.m16n8k8``) and 16 in bf16x3
    (``mma.m16n8k16``), whose steps past ``n_fft/2`` meet zero rows."""
    s_lo, s_hi = (n_fft - win_length) // 2 // 8, (n_fft // 2 + 8) // 8
    if dft_precision == "bf16x3":
        return s_lo // 2, (s_hi + 1) // 2
    return s_lo, s_hi


def _folded_basis(n_fft: int, win_length: int, rows: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The folded windowed rDFT basis (see :func:`dft_fragments`) for
    ``n`` in ``[0, rows)``, float64 ``(rows, 8*ceil(F/8))`` each: the cos
    part ``C`` and the sin part ``S``, zero past ``n_fft/2`` and past bin
    ``F - 1``."""
    F = 1 + n_fft // 2
    n_groups = -(-F // 8)
    window = ref.pad_center(ref.hann_window(win_length), n_fft)
    n = np.arange(rows)[:, None]
    k = np.arange(F)[None, :]
    ang = 2.0 * np.pi * ((n * k) % n_fft) / n_fft
    w = np.where(n <= n_fft // 2, window[np.minimum(n, n_fft - 1)], 0.0)
    half = n_fft // 2
    cos = np.zeros((rows, 8 * n_groups))
    sin = np.zeros_like(cos)
    cos[:, :F] = np.cos(ang) * w * np.where(n == half, 0.5, 1.0)
    sin[:, :F] = -np.sin(ang) * w * ((n > 0) & (n < half))
    return cos, sin


@functools.lru_cache(maxsize=8)
def dft_fragments(n_fft: int, win_length: int,
                  dft_precision: str = "highest") -> np.ndarray:
    """The kernels' folded windowed rDFT basis, split into TF32 halves and
    laid out in the order the ``mma.m16n8k8`` B fragments read it
    (``'highest'``), or into bf16 halves in the order of ``mma.m16n8k16``'s
    (``'bf16x3'``).

    The window ``w`` is symmetric about ``n_fft/2`` and zero at ``n = 0``,
    so ``Re X_k = sum_n C[n, k] e_n`` and ``Im X_k = sum_n S[n, k] o_n``
    over ``n`` in ``[0, n_fft/2]``, with ``e_n = x_n + x_{N-n}`` and
    ``o_n = x_n - x_{N-n}`` (``x_N`` meets only zeros), where ``C[n, k] =
    c_n w_n cos(2 pi n k / N)`` (``c_{N/2} = 1/2``, else 1) and ``S[n, k] =
    -w_n sin(2 pi n k / N)`` for ``0 < n < N/2`` (zero elsewhere), built in
    float64 for bins ``k < F`` (zero beyond, up to ``8*ceil(F/8)``).
    ``hi = tf32(.)``, ``lo = tf32(. - hi)``.  Entry ``[s - s_lo, 2*q + p,
    lane]`` (``s`` a k-step of :func:`dft_steps`, ``q`` a group of 8 bins,
    ``p`` 0 for ``C`` and 1 for ``S``, ``g = lane // 4``, ``r = lane % 4``)
    holds ``(hi[8s+r, 8q+g], hi[8s+r+4, 8q+g], lo[8s+r, 8q+g], lo[8s+r+4,
    8q+g])`` of that matrix: the lane's fragment registers b0 and b1 of both
    halves, one 16-byte load.  Returns float32 ``(s_hi - s_lo, 2 *
    n_groups, 32, 4)``.

    ``'bf16x3'``: ``hi = bf16(.)``, ``lo = bf16(. - hi)`` of the same
    float64 basis, k-steps of 16 rows (:func:`dft_steps`); entry ``[s -
    s_lo, 2*q + p, lane]`` holds four bf16x2 words ``(hi b0, hi b1, lo b0,
    lo b1)``, b0 holding rows ``16s + 2r`` (low half) and ``16s + 2r + 1``
    (high half) of bin ``8q + g``, b1 rows ``16s + 2r + 8`` and ``+ 9``.
    Returns int32 ``(s_hi - s_lo, 2 * n_groups, 32, 4)`` of those bits."""
    if (n_fft - win_length) % 2:
        raise ValueError("the kernels fold the frame about n_fft/2 and take "
                         "a window centred symmetrically: n_fft - win_length "
                         "must be even")
    _nvcc.check_precision(dft_precision)
    F = 1 + n_fft // 2
    n_groups = -(-F // 8)
    s_lo, s_hi = dft_steps(n_fft, win_length, dft_precision)
    lane = np.arange(32)
    if dft_precision == "bf16x3":
        cos, sin = _folded_basis(n_fft, win_length, 16 * s_hi)
        rows = (16 * np.arange(s_lo, s_hi)[:, None, None]
                + 2 * (lane % 4)[None, None])
        cols = 8 * np.arange(n_groups)[None, :, None] + (lane // 4)[None, None]
        parts = []
        for basis in (cos, sin):
            hi = bf16_round(basis)
            lo = bf16_round(basis - hi)
            words = []
            for half in (hi, lo):
                bits = (half.astype(np.float32).view(np.uint32)
                        >> np.uint32(16))
                for r in (rows, rows + 8):
                    words.append(bits[r, cols] | (bits[r + 1, cols]
                                                  << np.uint32(16)))
            parts.append(np.stack(words, axis=-1))
        frag = np.stack(parts, axis=2)      # (steps, n_groups, 2, 32, 4)
        return frag.reshape(s_hi - s_lo, 2 * n_groups, 32, 4).view(np.int32)
    cos, sin = _folded_basis(n_fft, win_length, 8 * s_hi)
    rows = 8 * np.arange(s_lo, s_hi)[:, None, None] + (lane % 4)[None, None]
    cols = 8 * np.arange(n_groups)[None, :, None] + (lane // 4)[None, None]
    parts = []
    for basis in (cos, sin):
        hi = tf32_round(basis)
        lo = tf32_round(basis - hi)
        parts.append(np.stack([hi[rows, cols], hi[rows + 4, cols],
                               lo[rows, cols], lo[rows + 4, cols]], axis=-1))
    frag = np.stack(parts, axis=2)          # (steps, n_groups, 2, 32, 4)
    return frag.reshape(s_hi - s_lo, 2 * n_groups, 32, 4).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _fragments_on(n_fft: int, win_length: int, device: torch.device,
                  dft_precision: str = "highest") -> torch.Tensor:
    return torch.as_tensor(dft_fragments(n_fft, win_length, dft_precision),
                           device=device)


@functools.lru_cache(maxsize=8)
def _bf16_halves(n_fft: int, win_length: int) -> tuple[np.ndarray, ...]:
    """The bf16x3 kernels' basis halves as float32 matrices ``(n_fft/2 + 1,
    F)``: ``C_hi, C_lo, S_hi, S_lo`` (:func:`dft_fragments`)."""
    half, F = n_fft // 2, 1 + n_fft // 2
    out = []
    for basis in _folded_basis(n_fft, win_length, half + 1):
        hi = bf16_round(basis[:, :F])
        out += [hi.astype(np.float32),
                bf16_round(basis[:, :F] - hi).astype(np.float32)]
    return tuple(out)


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def stft_mag_bf16x3(y: torch.Tensor, *, n_fft: int, win_length: int,
                    hop_length: int) -> torch.Tensor:
    """The magnitudes the bf16x3 kernels compute, ``(..., n_samples)`` ->
    ``(..., F, T)`` float32 (float32 arithmetic for any input): each frame
    folded about ``n_fft/2`` into ``e_n = x_n + x_{N-n}`` and ``o_n = x_n -
    x_{N-n}`` (``x_N``, which meets only zero basis rows, taken as 0),
    each split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, and ``lo
    hi + hi lo + hi hi`` against the basis halves in float32 (a product of
    two bf16 values is exact there), ``lo lo`` dropped."""
    frames = y.to(torch.float32).unfold(-1, n_fft, hop_length)
    half = n_fft // 2
    x = frames[..., :half + 1]
    z = torch.cat([torch.zeros_like(frames[..., :1]),
                   frames[..., half:].flip(-1)], dim=-1)
    parts = []
    halves = [torch.as_tensor(h, device=y.device)
              for h in _bf16_halves(n_fft, win_length)]
    for a, b_hi, b_lo in ((x + z, *halves[:2]), (x - z, *halves[2:])):
        a_hi = _to_bf16(a)
        a_lo = _to_bf16(a - a_hi)
        parts.append(a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi)
    re, im = parts
    return torch.sqrt(re * re + im * im).transpose(-1, -2)


def _edge_flags(halo_in_audio: bool, edge_flags) -> tuple[int, int]:
    """``edge_flags`` as two ints in {0, 1}; without halo only (1, 1)."""
    flags = tuple(int(f) for f in edge_flags)
    if len(flags) != 2 or not set(flags) <= {0, 1}:
        raise ValueError(f"edge_flags must be two of 0 and 1, got "
                         f"{edge_flags!r}")
    if not halo_in_audio and flags != (1, 1):
        raise ValueError("edge_flags other than (1, 1) need halo_in_audio: "
                         "without a halo both edges are global")
    return flags


def stft_hpss_mel_plain(y: torch.Tensor, mel_basis: torch.Tensor, *,
                        n_fft: int = 400, win_length: int = 400,
                        hop_length: int = 160, l_harm: int = 21,
                        l_perc: int = 11, power: float = 2.0,
                        dft_precision: str = "highest",
                        halo_in_audio: bool = False, edge_flags=(1, 1)
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """stft_mag -> hpss -> mel projection: ``(..., N)`` audio and an
    ``(n_mels, F)`` basis -> two ``(..., n_mels, T)`` maps, float32 (all of
    it in float64 for float64 audio at ``'highest'``).  ``'bf16x3'`` takes
    :func:`stft_mag_bf16x3` in place of ``stft_mag``.  Halo mode as in the
    module doc."""
    H, P = stft_hpss_plain(y, n_fft=n_fft, win_length=win_length,
                           hop_length=hop_length, l_harm=l_harm,
                           l_perc=l_perc, power=power,
                           dft_precision=dft_precision,
                           halo_in_audio=halo_in_audio, edge_flags=edge_flags)
    M = mel_basis.to(device=H.device, dtype=H.dtype)
    return torch.matmul(M, H), torch.matmul(M, P)


def stft_hpss_plain(y: torch.Tensor, *, n_fft: int = 400,
                    win_length: int = 400, hop_length: int = 160,
                    l_harm: int = 21, l_perc: int = 11, power: float = 2.0,
                    dft_precision: str = "highest",
                    halo_in_audio: bool = False, edge_flags=(1, 1)
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """stft_mag (or :func:`stft_mag_bf16x3`) -> hpss: ``(..., N)`` audio ->
    two ``(..., F, T)`` maps.  In halo mode the harmonic median runs over
    the halo frames of each side whose flag is 0 and mirrors at each side
    whose flag is 1."""
    ml, mr = _edge_flags(halo_in_audio, edge_flags)
    _nvcc.check_precision(dft_precision)
    mag = stft_mag_bf16x3 if dft_precision == "bf16x3" else stft_mag
    S = mag(y, n_fft=n_fft, win_length=win_length, hop_length=hop_length)
    if not halo_in_audio:
        return hpss_plain(S, l_harm=l_harm, l_perc=l_perc, power=power)
    ht = l_harm // 2
    T = S.shape[-1] - 2 * ht
    if T < 1:
        raise ValueError(f"halo mode needs more than {2 * ht} frames, got "
                         f"{S.shape[-1]}")
    if ml and mr:
        return hpss_plain(S[..., ht:ht + T], l_harm=l_harm, l_perc=l_perc,
                          power=power)
    f = torch.arange(-ht, T + ht, device=S.device)
    lo, hi = (0 if ml else -ht), (T if mr else T + ht)
    f = torch.where(f < lo, -1 - f, torch.where(f >= hi, 2 * T - 1 - f, f))
    return hpss_mod.hpss_from_extended(S.index_select(-1, f + ht),
                                       l_harm=l_harm, l_perc=l_perc,
                                       power=power)


def launch(y: torch.Tensor, M: torch.Tensor | None, *, n_fft: int,
           win_length: int, hop_length: int, l_harm: int, l_perc: int,
           power: float = 2.0, dft_precision: str = "highest",
           halo_in_audio: bool = False, edge_flags=(1, 1)
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 with a mel basis ``M``; K2 (full resolution) with ``M=None``, on
    CUDA audio ``(..., N)`` of any length of at least one frame (in halo
    mode, of more than ``2*(l_harm//2)`` frames), at ``power`` and
    ``dft_precision``.  The dispatchers send clips under ``2*(l_harm//2)``
    frames elsewhere; this launches the fused kernel whatever the
    length."""
    ml, mr = _edge_flags(halo_in_audio, edge_flags)
    _nvcc.check_precision(dft_precision)
    F = 1 + n_fft // 2
    if y.dtype != torch.float32:
        raise TypeError("frontend kernel takes float32 audio")
    if M is not None:
        if M.dtype != torch.float32:
            raise TypeError("stft_hpss_mel kernel takes a float32 basis")
        if M.device != y.device:
            raise ValueError("mel_basis must be on the audio's device")
        if M.ndim != 2 or M.shape[1] != F:
            raise ValueError(f"mel_basis must be (n_mels, {F}), "
                             f"got {tuple(M.shape)}")
    check_pair(l_harm, l_perc)
    if not win_length <= n_fft:
        raise ValueError("win_length must not exceed n_fft")
    if n_fft % 8 or hop_length % 8:
        raise ValueError(f"kernel takes n_fft and hop_length that are "
                         f"multiples of 8, got {n_fft} and {hop_length}")
    if (n_fft - win_length) % 2:
        raise ValueError("kernel takes a window centred symmetrically: "
                         "n_fft - win_length must be even")
    lead, N = y.shape[:-1], y.shape[-1]
    halo = 2 * (l_harm // 2) if halo_in_audio else 0
    T = n_frames(N, n_fft, hop_length) - halo
    if T < 1:
        raise ValueError(f"{N} samples are shorter than {halo + 1} frames "
                         f"of {n_fft}")
    y2 = y.reshape(-1, N).contiguous()
    B = y2.shape[0]
    rows = F if M is None else M.shape[0]
    out_h = torch.empty((B, rows, T), dtype=torch.float32, device=y.device)
    out_p = torch.empty_like(out_h)
    shape = lead + (rows, T)
    if B == 0:
        return out_h.reshape(shape), out_p.reshape(shape)
    basis = _fragments_on(n_fft, win_length, y.device, dft_precision)
    if M is None:
        name, fn, mel, n_mels = "stft_hpss", "k2_stft_hpss", (), ()
    else:
        M = M.contiguous()
        name, fn = "stft_hpss_mel", "k1_stft_hpss_mel"
        mel, n_mels = (M.data_ptr(), _band_ranges_of(M).data_ptr()), (rows,)
    _nvcc.launch(_SOURCE, fn, y.device, y2.data_ptr(), basis.data_ptr(), *mel,
                 out_h.data_ptr(), out_p.data_ptr(), B, N, T, n_fft,
                 win_length, hop_length, l_harm, l_perc, *n_mels,
                 int(halo_in_audio), ml, mr, power, pair=(l_harm, l_perc),
                 dft_precision=dft_precision, name=name)
    count(f"{name}.launches")
    count(f"{name}.launches_by_precision.{dft_precision}")
    count(f"{name}.launches_by_pair.{l_harm},{l_perc}")
    count(f"{name}.launches_by_power.{float(power)}")
    if halo_in_audio:
        count(f"{name}.launches_halo")
    return out_h.reshape(shape), out_p.reshape(shape)


def _short_clip(T: int, l_harm: int, halo_in_audio: bool) -> bool:
    """Whether a clip of ``T`` frames takes the short-clip route: fewer than
    ``2*(l_harm//2)`` frames, out of halo mode (``frontend_pallas.
    _dispatch``'s rule, whatever the precision)."""
    return not halo_in_audio and 1 <= T < 2 * (l_harm // 2)


def _dispatch(y: torch.Tensor, M: torch.Tensor | None, *, n_fft,
              win_length, hop_length, l_harm, l_perc, power=2.0,
              dft_precision="highest", halo_in_audio=False,
              edge_flags=(1, 1)):
    """The CUDA route of :func:`stft_hpss_mel` (``M`` given) and
    :func:`stft_hpss` (``M=None``): clips under ``2*(l_harm//2)`` frames go
    through the float32 ``stft_mag`` and K4 or K3 whatever the
    ``dft_precision``, as ``frontend_pallas._dispatch`` sends them to
    ``hpss_pallas``; longer ones, and every halo-mode call, launch K1 or
    K2."""
    T = n_frames(y.shape[-1], n_fft, hop_length)
    if _short_clip(T, l_harm, halo_in_audio):
        S = stft_mag(y.to(torch.float32), n_fft=n_fft,
                     win_length=win_length, hop_length=hop_length)
        if M is None:
            return hpss_mod.hpss(S, l_harm=l_harm, l_perc=l_perc, power=power)
        return hpss_mod.hpss_mel(S, M, l_harm=l_harm, l_perc=l_perc,
                                 power=power)
    return launch(y, M, n_fft=n_fft, win_length=win_length,
                  hop_length=hop_length, l_harm=l_harm, l_perc=l_perc,
                  power=power, dft_precision=dft_precision,
                  halo_in_audio=halo_in_audio, edge_flags=edge_flags)


def _route(op: str, y: torch.Tensor, M: torch.Tensor | None, **kw):
    """The route of :func:`stft_hpss_mel` (``M`` given) and
    :func:`stft_hpss` (``M=None``): :func:`_dispatch` on CUDA; on the CPU
    its plain version, where a short clip takes ``'highest'`` (the float32
    ``stft_mag``) as :func:`_dispatch` does."""
    _nvcc.check_precision(kw["dft_precision"])
    if _nvcc.on_card(op, y):
        return _dispatch(y, M, **kw)
    T = n_frames(y.shape[-1], kw["n_fft"], kw["hop_length"])
    if _short_clip(T, kw["l_harm"], kw["halo_in_audio"]):
        kw["dft_precision"] = "highest"
    if M is None:
        return stft_hpss_plain(y, **kw)
    return stft_hpss_mel_plain(y, M, **kw)


def stft_hpss_mel(y: torch.Tensor, mel_basis: torch.Tensor, *,
                  n_fft: int = 400, win_length: int = 400,
                  hop_length: int = 160, l_harm: int = 21, l_perc: int = 11,
                  power: float = 2.0, dft_precision: str = "highest",
                  halo_in_audio: bool = False, edge_flags=(1, 1)
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Audio ``(..., N)`` -> ``(mel(H), mel(P))``, each ``(..., n_mels, T)``.

    ``mel_basis`` is ``(n_mels, F)``.  ``dft_precision`` and ``power`` as in
    the module doc: ``'highest'`` (the port's default; split TF32, close to
    float32) serves the JAX package's ``'highest'`` within its bars,
    ``'bf16x3'`` its default.  CPU tensors take the plain version; CUDA
    tensors launch K1 (each launch adds one to the counters
    ``stft_hpss_mel.launches``,
    ``stft_hpss_mel.launches_by_precision.<dft_precision>``,
    ``stft_hpss_mel.launches_by_pair.<l_harm>,<l_perc>``,
    ``stft_hpss_mel.launches_by_power.<float power>`` and in halo mode
    ``stft_hpss_mel.launches_halo`` of ``utils.profiling.counters()``), or
    for clips under ``2*(l_harm//2)`` frames the plain ``stft_mag`` and K4.
    Halo mode as in the module doc (always K1 on CUDA)."""
    return _route("stft_hpss_mel", y, mel_basis, n_fft=n_fft,
                  win_length=win_length, hop_length=hop_length,
                  l_harm=l_harm, l_perc=l_perc, power=power,
                  dft_precision=dft_precision, halo_in_audio=halo_in_audio,
                  edge_flags=edge_flags)


def stft_hpss(y: torch.Tensor, *, n_fft: int = 400, win_length: int = 400,
              hop_length: int = 160, l_harm: int = 21, l_perc: int = 11,
              power: float = 2.0, dft_precision: str = "highest",
              halo_in_audio: bool = False, edge_flags=(1, 1)
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Audio ``(..., N)`` -> full-resolution ``(H, P)`` masked magnitudes,
    each ``(..., F, T)``: the HarmSpec/PercSpec feature families.

    Modes as in :func:`stft_hpss_mel`.  CPU tensors take the plain version;
    CUDA tensors launch K2 (each launch adds one to K1's counters, named
    ``stft_hpss.*``), or for
    clips under ``2*(l_harm//2)`` frames the plain ``stft_mag`` and K3."""
    return _route("stft_hpss", y, None, n_fft=n_fft, win_length=win_length,
                  hop_length=hop_length, l_harm=l_harm, l_perc=l_perc,
                  power=power, dft_precision=dft_precision,
                  halo_in_audio=halo_in_audio, edge_flags=edge_flags)

