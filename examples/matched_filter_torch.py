#!/usr/bin/env python
"""Matched-filter detection pipeline on the port's fused kernels.

The PyTorch counterpart of ``examples/matched_filter.py``: the same
streams, templates and detections, over ``smfft_tpu_torch``.  The
reference library exists to feed exactly this shape of pipeline
(reference README.md:10 — shared-memory FFTs for convolution; its home
project Astro-Accelerate searches pulsar surveys by correlating
dedispersed streams against template banks):

  1. simulate noisy streams with pulse templates embedded at random
     offsets (numpy's generator seeded 7, as the JAX example, so both
     see the same data),
  2. correlate every stream against the whole template bank with ONE
     fused kernel launch (``conv_real_kernel``: each signal's r2c is
     computed once for the whole bank — ``api.convolve_real`` bank mode),
  3. detect: z-scored peak over the correlation lag surface, on the
     device.

Run:  python examples/matched_filter_torch.py [--streams 64] [--selfcheck]
      [--device cuda|cpu]
The default device is the card; without one the example stops and says
so.  ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def make_templates(m, k, rng):
    """Gaussian-envelope chirps with distinct chirp rates, unit energy."""
    t = np.linspace(-1.0, 1.0, k)
    rates = np.linspace(4.0, 14.0, m)
    bank = np.stack([np.exp(-4.0 * t ** 2) * np.cos(2 * np.pi * r * t ** 2)
                     for r in rates])
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    return bank.astype(np.float32)


def simulate(b, t, m, k, snr, rng):
    """(bank, planted template per stream, planted offset, streams), drawn
    in the JAX example's order."""
    bank = make_templates(m, k, rng)
    truth_tpl = rng.integers(0, m, b)
    truth_off = rng.integers(0, t - k, b)
    x = (rng.standard_normal((b, t)) / np.sqrt(k)).astype(np.float32)
    for i in range(b):
        x[i, truth_off[i]:truth_off[i] + k] += snr * bank[truth_tpl[i]]
    return bank, truth_tpl, truth_off, x


def filter_bank(bank, n, device):
    """rfft of the time-REVERSED templates, zero-padded to n: circular
    convolution with h[::-1] is cross-correlation (matched filtering)."""
    from smfft_tpu_torch import api
    m, k = bank.shape
    taps = np.zeros((m, n), np.float32)
    taps[:, :k] = bank[:, ::-1]
    return api.rfft(torch.from_numpy(taps).to(device))   # (m, n/2+1)


def correlate(x, hf):
    """Every stream against every template, one fused kernel launch:
    (b, n) against (m, n/2+1) -> (m, b, n)."""
    from smfft_tpu_torch import api
    return api.convolve_real(x, hf)


def detect(corr, k, t):
    """Peak z-score over the valid lags: (template, lag, z) per stream."""
    flat = corr[:, :, k - 1:t]                     # valid cross-corr lags
    mean = flat.mean(-1, keepdim=True)
    std = flat.std(-1, correction=0, keepdim=True)
    best, lag = ((flat - mean) / std).max(-1)      # (m, b) peak z per pair
    det_z, det_tpl = best.max(0)                   # template id per stream
    det_off = lag.gather(0, det_tpl[None])[0]
    return det_tpl.cpu().numpy(), det_off.cpu().numpy(), det_z.cpu().numpy()


def main(argv=None, result=None):
    p = argparse.ArgumentParser()
    p.add_argument("--streams", type=int, default=64)
    p.add_argument("--length", type=int, default=4096)
    p.add_argument("--templates", type=int, default=8)
    p.add_argument("--klen", type=int, default=256)
    p.add_argument("--snr", type=float, default=0.6)
    p.add_argument("--selfcheck", action="store_true",
                   help="verify detections against the planted truth")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the kernels run (default: the card)")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("matched_filter_torch: no CUDA device (torch.cuda."
              "is_available() is false); pass --device cpu to run the "
              "plain versions on the CPU", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    rng = np.random.default_rng(7)
    b, t, m, k = args.streams, args.length, args.templates, args.klen
    n = t  # one circular frame per stream (t a supported size)
    bank, truth_tpl, truth_off, x = simulate(b, t, m, k, args.snr, rng)

    hf = filter_bank(bank, n, device)           # (m, n/2+1), one-time
    # the hot loop: every stream against every template, ONE fused
    # kernel — each signal's r2c is computed once for the whole bank
    corr = correlate(torch.from_numpy(x).to(device), hf)   # (m, b, n)
    det_tpl, det_off, det_z = detect(corr, k, t)
    del corr

    hits = np.sum((det_tpl == truth_tpl) & (np.abs(det_off - truth_off) <= 1))
    print(f"streams={b} templates={m} length={t} K={k} snr={args.snr}")
    print(f"detected {hits}/{b} planted pulses "
          f"(median peak z = {np.median(det_z):.1f})")
    for i in range(min(b, 5)):
        mark = "ok " if (det_tpl[i] == truth_tpl[i]
                         and abs(det_off[i] - truth_off[i]) <= 1) else "MISS"
        print(f"  stream {i:3d}: template {det_tpl[i]} @ lag {det_off[i]:5d} "
              f"z={det_z[i]:5.1f}  (truth: {truth_tpl[i]} @ "
              f"{truth_off[i]:5d})  {mark}")
    if result is not None:
        result.update(det_tpl=det_tpl, det_off=det_off, det_z=det_z,
                      truth_tpl=truth_tpl, truth_off=truth_off, hits=hits)
    if args.selfcheck:
        if hits < int(0.9 * b):
            print(f"SELFCHECK FAILED: only {hits}/{b} detected")
            return 1
        print("SELFCHECK PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
