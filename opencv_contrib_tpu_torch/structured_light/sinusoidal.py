"""Sinusoidal-pattern profilometry: PSP, FTP and FAPS demodulation (the port
of opencv_contrib_tpu/structured_light/sinusoidal.py).

Parity: structured_light/src/sinusoidalpattern.cpp:
- PSP N-step phase shifting (computePsPhaseMap, :309);
- FTP Fourier-transform profilometry (:287-306): DC-suppressed sideband
  band-pass in the spectrum, inverse DFT of the half-spectrum, phase of
  the analytic signal (computeFtPhaseMap :476);
- FAPS Fourier-assisted phase shifting (:340-390): per-pattern FTP phase,
  unwrap, pairwise phase differences theta1/theta2 feeding the
  computeFapsPhaseMap closed form (:677-717).

Spectra by torch.fft (cuFFT on the card); the reference's spectrum maximum
search and rectangular band-pass are an argmax (the first maximum, as XLA
takes it) and a coordinate-mask select, with no host read.
"""

from __future__ import annotations

import math

import torch

from opencv_contrib_tpu_torch.phase_unwrapping.unwrap import unwrap_phase_dct


def generate_psp_patterns(proj_w: int, proj_h: int, n_periods: int = 8, n_shifts: int = 3):
    """n_shifts phase-shifted sinusoidal fringe patterns (P, H, W) in [0,1]."""
    x = torch.arange(proj_w, dtype=torch.float32)
    pats = []
    for k in range(n_shifts):
        phase = 2 * math.pi * n_periods * x / proj_w + 2 * math.pi * k / n_shifts
        row = 0.5 + 0.5 * torch.cos(phase)
        pats.append(row[None, :].expand(proj_h, proj_w))
    return torch.stack(pats)


def compute_psp_phase(captured: torch.Tensor):
    """Wrapped phase + modulation amplitude from N-step phase shifting.

    captured (N, H, W). Returns (wrapped phase (-pi, pi], amplitude)."""
    N = captured.shape[0]
    k = torch.arange(N, dtype=torch.float32, device=captured.device)
    s = torch.einsum("n,nhw->hw", torch.sin(2 * math.pi * k / N), captured)
    c = torch.einsum("n,nhw->hw", torch.cos(2 * math.pi * k / N), captured)
    phase = -torch.atan2(s, c)
    amp = 2.0 / N * torch.sqrt(s * s + c * c)
    return phase, amp


def compute_shadow_mask(captured: torch.Tensor, thresh: float = 0.1) -> torch.Tensor:
    """Valid where at least one pattern lights the pixel
    (computeShadowMask)."""
    hi = captured.amax(dim=0)
    rng = hi - captured.amin(dim=0)
    return (hi > thresh) & (rng > 0.02)


def _sideband_analytic(img: torch.Tensor, dc_half: int = 5, bp_half: int = 21) -> torch.Tensor:
    """DC-suppressed carrier-sideband band-pass of one fringe image ->
    complex analytic signal (the FTP spectrum pipeline: computeDft ->
    swapQuadrants -> frequencyFiltering(DC out) -> findMaxInHalvesTransform
    -> frequencyFiltering(keep band) -> inverse DFT)."""
    H, W = img.shape
    F = torch.fft.fftshift(torch.fft.fft2(img.to(torch.float32)))
    cy, cx = H // 2, W // 2
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    zero = torch.zeros((), dtype=F.dtype, device=img.device)
    # suppress the DC block
    dc = (torch.abs(yy - cy) <= dc_half) & (torch.abs(xx - cx) <= dc_half)
    F = torch.where(dc, zero, F)
    # carrier peak in the right half-plane (positive-frequency sideband)
    mag = torch.abs(F) * (xx > cx)
    idx = torch.argmax(mag.reshape(-1))
    my, mx = idx // W, idx % W
    band = (torch.abs(yy - my) <= bp_half) & (torch.abs(xx - mx) <= bp_half)
    Fb = torch.where(band, F, zero)
    return torch.fft.ifft2(torch.fft.ifftshift(Fb))


def compute_ftp_phase(img: torch.Tensor, mask: torch.Tensor | None = None):
    """FTP wrapped phase of a single fringe image (computeFtPhaseMap,
    sinusoidalpattern.cpp:476: atan2(re, im) of the analytic signal).
    Returns phase in (-pi, pi], zero outside the mask."""
    z = _sideband_analytic(img)
    phase = torch.atan2(z.real, z.imag)
    if mask is not None:
        phase = phase * mask
    return phase


def _unwrap_anchored(psi: torch.Tensor) -> torch.Tensor:
    """The DCT least-squares unwrap is gradient-based and loses the global
    constant, but theta1 / theta2 are that constant (the phase-shift step):
    re-anchor so u == psi (mod 2 pi) on average, like the reference's
    congruent HistogramPhaseUnwrapping."""
    u = unwrap_phase_dct(psi)
    off = torch.angle(torch.mean(torch.exp(1j * (psi - u))))
    return u + off


def compute_faps_phase(captured: torch.Tensor, mask: torch.Tensor | None = None):
    """FAPS wrapped phase from 3 shifted fringe images
    (sinusoidalpattern.cpp:340-390 + computeFapsPhaseMap :677):
    per-pattern FTP phase -> unwrap -> theta1/theta2 phase-step estimates,
    then atan2((1-cos t2) a + (1-cos t1) b, sin(t1) b - sin(t2) a) with
    a = f0-f1, b = f1-f2 of the band-passed (marker-free) patterns."""
    if mask is None:
        mask = compute_shadow_mask(captured)
    z = [_sideband_analytic(captured[i]) for i in range(3)]
    # band-passed real patterns (computeInverseDft(..., true) magnitude-real
    # path): the filtered fringe without DC / markers
    f = [2.0 * zi.real for zi in z]
    u = [_unwrap_anchored(torch.atan2(zi.real, zi.imag)) for zi in z]
    a = f[0] - f[1]
    b = f[1] - f[2]
    t1 = u[1] - u[0]
    t2 = u[2] - u[1]
    num = (1.0 - torch.cos(t2)) * a + (1.0 - torch.cos(t1)) * b
    den = torch.sin(t1) * b - torch.sin(t2) * a
    return torch.atan2(num, den) * mask
