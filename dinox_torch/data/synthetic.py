"""Synthetic five-dataset CT generator v2: the port's copy of
``dinox_tpu.data.synthetic``.

The numpy parts (profiles, ``scaled_profiles_v2``, ``_resize3d``,
``synth_series_np``, ``synth_two_organ_series_np``, ``draw_spacing``) are
bit-for-bit copies: the on-disk writer's series are the JAX package's.
:func:`make_batch_fn` is the twin of ``make_jax_batch_fn``: the same
parametric formula evaluated on the card in chunks of 16 slices, with its
random draws from an explicit ``torch.Generator`` (they cannot be the same
bits as ``jax.random``; the function keeps the contract and statistics).
Five structurally distinct profiles, each a window-invariant signature:

  lidc_like      thin-slice lung: sparse bright specks on an airy background
  mayo_like      low-dose chest: lung-like base under heavy pixel noise
  pancreas_like  contrast abdomen: large smooth coarse blobs
  cq500_like     non-contrast head: bright skull-like ring
  colon_like     CT colonography: directional periodic bands

  HU = mean + std*((1-mix)*coarse + mix*fine) + ring + bands + specks + noise
       (air outside the body ellipse)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "SynthProfile",
    "PROFILES_V2",
    "PROFILE_NAMES_V2",
    "SAMPLING_WEIGHTS_V2",
    "scaled_profiles_v2",
    "synth_series_np",
    "make_batch_fn",
    "upsample",
]


@dataclass(frozen=True)
class SynthProfile:
    """One dataset's generation parameters (all HU unless noted)."""

    name: str
    mean: float           # tissue background mean
    std: float            # blob-field contrast
    fine_mix: float       # 0 = coarse blobs only, 1 = fine texture only
    ring_amp: float       # skull-like ring amplitude (0 = off)
    band_amp: float       # oriented periodic band amplitude (0 = off)
    band_freq: float      # bands per unit radius (~canvas/2 pixels)
    speck_amp: float      # sparse bright speck amplitude (0 = off)
    speck_thresh: float   # threshold on the unit-variance fine field (higher
                          # = sparser specks)
    noise_std: float      # iid pixel noise sigma
    sp_min: tuple         # (x, y, z) spacing lower bound, mm
    sp_max: tuple         # (x, y, z) spacing upper bound, mm


# Ordered as sampled; weights echo descending catalog sizes (temperature-style
# T=2 over the five CT catalog entries, matching the v1 weights).
PROFILES_V2 = (
    SynthProfile("lidc_like", -600.0, 250.0, 0.75, 0.0, 0.0, 0.0,
                 900.0, 1.1, 25.0, (0.5, 0.5, 1.0), (1.0, 1.0, 3.5)),
    SynthProfile("pancreas_like", 40.0, 140.0, 0.15, 0.0, 0.0, 0.0,
                 0.0, 99.0, 20.0, (0.6, 0.6, 2.0), (1.0, 1.0, 5.0)),
    SynthProfile("cq500_like", 30.0, 90.0, 0.25, 1300.0, 0.0, 0.0,
                 0.0, 99.0, 15.0, (0.4, 0.4, 2.5), (0.8, 0.8, 6.0)),
    SynthProfile("mayo_like", -500.0, 220.0, 0.60, 0.0, 0.0, 0.0,
                 600.0, 1.4, 120.0, (0.5, 0.5, 1.0), (1.0, 1.0, 4.0)),
    SynthProfile("colon_like", -150.0, 160.0, 0.40, 0.0, 260.0, 9.0,
                 0.0, 99.0, 25.0, (0.6, 0.6, 1.5), (1.0, 1.0, 5.0)),
)
PROFILE_NAMES_V2 = tuple(p.name for p in PROFILES_V2)
SAMPLING_WEIGHTS_V2 = (0.36, 0.22, 0.18, 0.14, 0.10)


def scaled_profiles_v2(strength: float) -> tuple:
    """Per-dataset signature-strength knob (round-5 causal probe experiment).

    Returns the five v2 profiles with every *dataset-identifying* component
    scaled by ``strength`` around the cross-profile common point:

    * parametric stats (mean, std, fine_mix, noise_std) are linearly
      inter/extrapolated between each profile and the unweighted
      cross-profile average — at 0 all five datasets share one parametric
      profile, at 1 they are exactly PROFILES_V2, above 1 they spread apart;
    * structural marks (ring_amp, band_amp, speck_amp) are multiplied by
      ``strength`` directly (averaging would bleed e.g. the skull ring into
      every dataset);
    * spacing ranges, band_freq, and speck_thresh are left alone (spacing
      deliberately overlaps across datasets; frequencies/thresholds define
      *what* the mark is, amplitude defines how visible it is).

    The probe-degradation mechanism (docs/ROUND4_RESULTS.md: series signal
    crowds out weak parametric dataset signatures over long training) predicts
    dataset-probe accuracy ~1.0 at large strength, chance at 0, and the
    observed mid-range degradation at 1.
    """
    s = float(strength)
    if s == 1.0:
        return PROFILES_V2
    c_mean = float(np.mean([p.mean for p in PROFILES_V2]))
    c_std = float(np.mean([p.std for p in PROFILES_V2]))
    c_mix = float(np.mean([p.fine_mix for p in PROFILES_V2]))
    c_noise = float(np.mean([p.noise_std for p in PROFILES_V2]))
    out = []
    for p in PROFILES_V2:
        out.append(SynthProfile(
            name=p.name,
            # mean kept inside the HU clip range so an extrapolated profile
            # cannot degenerate into all-air / all-bone
            mean=float(np.clip(c_mean + s * (p.mean - c_mean), -950.0, 2000.0)),
            std=float(max(10.0, c_std + s * (p.std - c_std))),
            fine_mix=float(np.clip(c_mix + s * (p.fine_mix - c_mix), 0.0, 1.0)),
            ring_amp=p.ring_amp * s,
            band_amp=p.band_amp * s,
            band_freq=p.band_freq,
            speck_amp=p.speck_amp * s,
            speck_thresh=p.speck_thresh,
            noise_std=float(max(0.0, c_noise + s * (p.noise_std - c_noise))),
            sp_min=p.sp_min,
            sp_max=p.sp_max,
        ))
    return tuple(out)


def _resize3d(field: np.ndarray, shape: tuple[int, int, int]) -> np.ndarray:
    """Trilinear upsample via separable 1-D linear interpolation (numpy-only;
    avoids a scipy dependency)."""
    out = field.astype(np.float32)
    for axis, target in enumerate(shape):
        n = out.shape[axis]
        if n == target:
            continue
        pos = np.linspace(0, n - 1, target)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        frac = (pos - lo).astype(np.float32)
        a = np.take(out, lo, axis=axis)
        b = np.take(out, hi, axis=axis)
        bshape = [1] * out.ndim
        bshape[axis] = target
        f = frac.reshape(bshape)
        out = a * (1 - f) + b * f
    return out


def synth_series_np(
    profile: SynthProfile,
    rng: np.random.Generator,
    n_slices: int,
    size: int,
) -> np.ndarray:
    """One z-coherent synthetic series (n_slices, size, size) in true HU."""
    zdim = max(2, n_slices // 2)
    coarse = _resize3d(rng.normal(size=(zdim, size // 32, size // 32)),
                       (n_slices, size, size))
    fine = _resize3d(rng.normal(size=(zdim, size // 8, size // 8)),
                     (n_slices, size, size))
    base = (1.0 - profile.fine_mix) * coarse + profile.fine_mix * fine

    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    # mildly random body ellipse per series
    ax = rng.uniform(0.78, 0.92)
    ay = rng.uniform(0.70, 0.88)
    r2 = (xx / ax) ** 2 + (yy / ay) ** 2
    body = r2 < 1.0

    hu = profile.mean + profile.std * base
    if profile.ring_amp > 0:
        r = np.sqrt(r2)
        ring = np.exp(-((r - 0.9) ** 2) / (2 * 0.035 ** 2))
        hu = hu + profile.ring_amp * ring[None]
    if profile.band_amp > 0:
        theta = rng.uniform(0, np.pi)
        phase = rng.uniform(0, 2 * np.pi, n_slices)[:, None, None]
        proj = xx * np.cos(theta) + yy * np.sin(theta)
        hu = hu + profile.band_amp * np.sin(
            2 * np.pi * profile.band_freq * proj[None] + phase)
    if profile.speck_amp > 0:
        hu = hu + profile.speck_amp * np.maximum(fine - profile.speck_thresh, 0.0)
    hu = hu + rng.normal(0, profile.noise_std, hu.shape)
    hu = np.where(body[None], hu, -1000.0)
    return np.clip(hu, -1000, 4000).astype(np.float32)


def synth_two_organ_series_np(
    organ: str, rng: np.random.Generator, n_slices: int, size: int
) -> tuple[np.ndarray, tuple]:
    """On-disk twin of the device two-organ MVP generator
    (scripts/pretrain.py make_two_organ): a 16x-coarse gaussian field with
    the organ's intensity stats and spacing range — the same-domain eval
    substrate for the 5K MVP ablation (round-3; the round-2 ablation eval
    used a domain-shifted set, VERDICT r2 weak #3). Returns (HU volume,
    per-series spacing)."""
    if organ == "organa":
        mean, std = -600.0, 300.0
        sp_lo, sp_hi = (0.5, 0.5, 1.0), (1.0, 1.0, 1.5)
    elif organ == "organb":
        mean, std = 40.0, 120.0
        sp_lo, sp_hi = (1.5, 1.5, 2.5), (3.0, 3.0, 5.0)
    else:
        raise ValueError(f"unknown organ {organ!r} (organa|organb)")
    zdim = max(2, n_slices // 2)
    field = _resize3d(rng.normal(size=(zdim, size // 16, size // 16)),
                      (n_slices, size, size))
    hu = np.clip(mean + std * field, -1000, 4000).astype(np.float32)
    sp = rng.uniform(np.asarray(sp_lo), np.asarray(sp_hi))
    return hu, (float(sp[0]), float(sp[0]), float(sp[2]))


def draw_spacing(profile: SynthProfile, rng: np.random.Generator) -> tuple:
    """Per-series spacing draw from the (overlapping) v2 ranges."""
    lo = np.asarray(profile.sp_min, np.float32)
    hi = np.asarray(profile.sp_max, np.float32)
    sp = rng.uniform(lo, hi)
    return (float(sp[0]), float(sp[0]), float(sp[2]))  # square xy pixels


# -- batched variant on the card (device staging) ---------------------------

# Slices generated at once: the working set (several f32 (m, canvas,
# canvas, 3) temporaries) is bounded by the chunk, not the batch.
_CHUNK = 16


def upsample(x: torch.Tensor, canvas: int) -> torch.Tensor:
    """(m, h, w, 3) -> (m, canvas, canvas, 3): linear interpolation with
    half-pixel centres and clamped edges (``jax.image.resize`` "linear"
    when it enlarges)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(canvas, canvas), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def make_batch_fn(canvas: int, n: int, signature_strength: float = 1.0,
                  device: torch.device | str | None = None):
    """Returns ``make(generator) -> (pixels (n, canvas, canvas, 3) uint16,
    spacing (n, 3) float32, ds (n,) int64)`` sampling the five v2 profiles
    on *device* (the card unless ``"cpu"``) from *generator*, a
    ``torch.Generator`` on that device.

    The twin of the JAX package's ``make_jax_batch_fn``: the 3 channels are
    the 2.5D (z-1, z, z+1) stack (one in-plane field, per-channel jitter),
    every per-dataset parameter is gathered from tables, the fields are
    drawn and enlarged in bfloat16, HU is clipped to [-1000, 4000] and
    stored as uint16 = HU + 32768. ``signature_strength`` scales the
    per-dataset signatures (:func:`scaled_profiles_v2`)."""
    from dinox_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    profiles = scaled_profiles_v2(signature_strength)

    def table(values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=dev)

    mean_t = table([p.mean for p in profiles])
    std_t = table([p.std for p in profiles])
    mix_t = table([p.fine_mix for p in profiles])
    ring_t = table([p.ring_amp for p in profiles])
    band_t = table([p.band_amp for p in profiles])
    bfreq_t = table([p.band_freq for p in profiles])
    speck_t = table([p.speck_amp for p in profiles])
    sthr_t = table([p.speck_thresh for p in profiles])
    noise_t = table([p.noise_std for p in profiles])
    spmin_t = table([p.sp_min for p in profiles])
    spmax_t = table([p.sp_max for p in profiles])
    w = np.asarray(SAMPLING_WEIGHTS_V2)
    weights = table(w / w.sum())
    lin = torch.linspace(-1, 1, canvas, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    yy, xx = yy[None, :, :, None], xx[None, :, :, None]

    def block(g: torch.Generator, m: int):
        def uniform(shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

        def per(t: torch.Tensor) -> torch.Tensor:
            return t[ds][:, None, None, None]

        ds = torch.multinomial(weights, m, replacement=True, generator=g)
        # bf16 fields, as the JAX generator draws them
        coarse = upsample(torch.randn((m, canvas // 32, canvas // 32, 3), generator=g, device=dev,
                                       dtype=torch.bfloat16), canvas)
        fine = upsample(torch.randn((m, canvas // 8, canvas // 8, 3), generator=g, device=dev,
                                     dtype=torch.bfloat16), canvas)
        mix = per(mix_t).to(torch.bfloat16)
        base = ((1.0 - mix) * coarse + mix * fine).float()
        ax = uniform((m, 1, 1, 1), 0.78, 0.92)
        ay = uniform((m, 1, 1, 1), 0.70, 0.88)
        r2 = (xx / ax) ** 2 + (yy / ay) ** 2
        body = r2 < 1.0

        hu = per(mean_t) + per(std_t) * base
        ring = torch.exp(-((torch.sqrt(r2) - 0.9) ** 2) / (2 * 0.035 ** 2))
        hu = hu + per(ring_t) * ring
        theta = uniform((m, 1, 1, 1), 0.0, np.pi)
        phase = uniform((m, 1, 1, 3), 0.0, 2 * np.pi)
        proj = xx * torch.cos(theta) + yy * torch.sin(theta)
        hu = hu + per(band_t) * torch.sin(2 * np.pi * per(bfreq_t) * proj + phase)
        hu = hu + per(speck_t) * torch.clamp(fine.float() - per(sthr_t), min=0.0)
        hu = hu + per(noise_t) * torch.randn(hu.shape, generator=g, device=dev)
        hu = torch.clamp(torch.where(body, hu, -1000.0), -1000.0, 4000.0)
        pixels = torch.clamp(hu + 32768.0, 0.0, 65535.0).to(torch.uint16)
        u = uniform((m, 3))
        spacing = spmin_t[ds] + u * (spmax_t[ds] - spmin_t[ds])
        spacing[:, 1] = spacing[:, 0]  # square xy pixels
        return pixels, spacing, ds

    def make(generator: torch.Generator):
        parts = [block(generator, min(_CHUNK, n - i)) for i in range(0, n, _CHUNK)]
        return tuple(torch.cat(p) for p in zip(*parts))

    return make
