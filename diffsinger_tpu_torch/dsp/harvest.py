"""Harvest f0 estimator (Morise 2017), native replacement for
``pyworld.harvest`` (reference modules/pe/pw.py:7 calls
``pw.harvest(x, fs, f0_floor, f0_ceil, frame_period)``).

(Own copy of diffsinger_tpu/dsp/harvest.py: numpy only, unchanged.)

Follows the published algorithm and the WORLD C++ pipeline structure:

1. **Candidate generation** on a ~8 kHz decimated signal: ~40
   band-pass channels per octave over [0.9·floor, 1.1·ceil]; each channel is
   the signal filtered by a Nuttall-windowed cosine band-pass centered at the
   channel boundary f0. Four interval-based instantaneous-frequency event
   sequences per channel (negative/positive zero crossings, peaks, dips) are
   interpolated onto a 1 ms grid; a channel votes an f0 candidate where their
   mean lies inside the channel band. Runs of >= 10 consecutive agreeing
   channels become official candidates; candidates are then overlapped from
   ±1..3 neighboring frames.
2. **Refinement**: each (position, candidate) is refined by the
   instantaneous-frequency spectrum of a 3-period Blackman-windowed frame:
   the amplitude-weighted mean of IF/k at the first <=6 harmonics, with a
   harmonic-consistency score; unreliable candidates (no close candidate in a
   neighboring frame) are removed.
3. **Contour fixing**: best-score base path; rapid-change removal; short
   voiced-run removal; section extension along remaining candidates; and a
   zero-phase low-pass smoothing of the voiced log-contour.
4. The 1 ms contour is sampled at the requested ``frame_period``.

Everything is vectorized float64 numpy (WORLD is double precision) and runs
host-side at binarization time — the same place the reference runs the
pyworld C++ code. Where the C++ uses empirically tuned constants they are
kept at the published/source values noted inline; bit-exact parity with
pyworld is not claimed (see tests/test_harvest.py for the behavioral
fixtures: synthetic vibrato, octave robustness, VUV).
"""

from __future__ import annotations

import numpy as np

# Bumped whenever estimator behavior changes (recorded into binarized .meta
# provenance so dataset feature compatibility is machine-checkable). v2: WORLD
# GetMeanF0 score normalization (mean deviation over number_of_harmonics,
# measured against the candidate, a·k-weighted refined mean). v3: refinement
# FFT sized per (position, candidate) pair like WORLD's GetMeanF0 (was: one
# global max-window FFT size for all pairs) — bucketed by class, ~3.5x faster
# end to end with nearest-neighbor candidate pruning in O(K log K).
ALGO_VERSION = 3

TARGET_FS = 8000.0
CHANNELS_IN_OCTAVE = 40.0
FRAME_PERIOD_CANDIDATES_MS = 1.0
MIN_AGREEING_CHANNELS = 10
OVERLAP_SHIFTS = 3
REFINE_SCORE_MIN = 2.5
NEIGHBOR_MAX_REL_ERROR = 0.05
FIX_STEP1_ALLOWED_RANGE = 0.008   # per 1 ms step
VOICE_RANGE_MINIMUM_MS = 9
EXTEND_ALLOWED_RANGE = 0.1
EXTEND_MISS_LIMIT = 4
SAFE = 1e-12


def _round(x):
    return np.floor(np.asarray(x, np.float64) + 0.5).astype(np.int64)


def _next_pow2(n: int) -> int:
    return int(2 ** np.ceil(np.log2(max(n, 2))))


# ---------------------------------------------------------------- candidates

def _decimate(x: np.ndarray, fs: int):
    ratio = int(_round(fs / TARGET_FS))
    if ratio <= 1:
        return x.astype(np.float64), float(fs)
    from scipy.signal import decimate

    y = decimate(x.astype(np.float64), ratio, ftype="iir", zero_phase=True)
    return y, fs / ratio


def _zero_crossing_events(sig: np.ndarray, fs: float):
    """Negative-going zero-crossing intervals of `sig`: returns
    (interval_midpoints_sec, frequencies). WORLD ZeroCrossingEngine."""
    s = sig
    neg = (s[:-1] > 0) & (s[1:] <= 0)
    idx = np.nonzero(neg)[0]
    if len(idx) < 3:
        return np.empty(0), np.empty(0)
    fine = idx + s[idx] / (s[idx] - s[idx + 1])  # linear-interp crossing
    intervals = np.diff(fine) / fs
    locations = (fine[:-1] + fine[1:]) / 2 / fs
    good = intervals > 0
    return locations[good], 1.0 / intervals[good]


def _four_contours(filtered: np.ndarray, fs: float, grid: np.ndarray):
    """Mean of the four interval-based IF estimates on the 1 ms grid; NaN
    where any estimator lacks events."""
    d = np.diff(filtered)
    out = np.zeros((4, len(grid)))
    ok = True
    for i, sig in enumerate([filtered, -filtered, d, -d]):
        loc, freq = _zero_crossing_events(sig, fs)
        if len(loc) < 2:
            ok = False
            break
        out[i] = np.interp(grid, loc, freq, left=0.0, right=0.0)
        # outside the observed event span the estimate is invalid
        out[i][(grid < loc[0]) | (grid > loc[-1])] = 0.0
    if not ok:
        return np.zeros(len(grid))
    mean = out.mean(axis=0)
    mean[(out <= 0).any(axis=0)] = 0.0
    return mean


def _raw_candidates(y: np.ndarray, fs: float, boundary_f0s: np.ndarray, grid: np.ndarray):
    """Per-channel f0 vote on the 1 ms grid: [C, T]."""
    n = len(y)
    max_half = int(_round(fs / boundary_f0s.min() * 2.0))
    fft_size = _next_pow2(n + 4 * max_half + 8)
    yspec = np.fft.rfft(y, n=fft_size)
    raw = np.zeros((len(boundary_f0s), len(grid)))
    for c, bf0 in enumerate(boundary_f0s):
        half = int(_round(fs / bf0 * 2.0))
        wl = 2 * half + 1
        k = np.arange(wl, dtype=np.float64)
        tmp = (k + 1 - (wl + 1) / 2.0) / (wl + 1)
        nuttall = (0.355768 + 0.487396 * np.cos(2 * np.pi * tmp)
                   + 0.144232 * np.cos(4 * np.pi * tmp)
                   + 0.012604 * np.cos(6 * np.pi * tmp))
        bp = nuttall * np.cos(2 * np.pi * bf0 * (k - half) / fs)
        fspec = np.fft.rfft(bp, n=fft_size)
        filtered = np.fft.irfft(yspec * fspec, n=fft_size)
        filtered = filtered[half: half + n]  # compensate the filter delay
        cand = _four_contours(filtered, fs, grid)
        bad = (cand < bf0 * 0.9) | (cand > bf0 * 1.1)
        cand[bad] = 0.0
        raw[c] = cand
    return raw


def _official_candidates(raw: np.ndarray):
    """Group runs of >=MIN_AGREEING_CHANNELS voiced channels per frame into
    candidates (the section mean). Returns [T, K] (zero-padded)."""
    c, t = raw.shape
    vuv = raw > 0
    cand_lists = []
    max_k = 1
    # vectorized run detection per frame via padded diff
    padded = np.zeros((c + 2, t), bool)
    padded[1:-1] = vuv
    starts = (~padded[:-1]) & padded[1:]   # [c+1, t]
    ends = padded[:-1] & (~padded[1:])
    for i in range(t):
        st = np.nonzero(starts[:, i])[0]
        ed = np.nonzero(ends[:, i])[0]
        vals = []
        for s, e in zip(st, ed):  # run raw[s:e, i]
            if e - s < MIN_AGREEING_CHANNELS:
                continue
            vals.append(raw[s:e, i].mean())
        cand_lists.append(vals)
        max_k = max(max_k, len(vals))
    out = np.zeros((t, max_k))
    for i, vals in enumerate(cand_lists):
        out[i, : len(vals)] = vals
    return out


def _overlap_candidates(cands: np.ndarray):
    """Copy candidates from frames ±1..3 (1 ms shifts): [T, K] -> [T, 7K]."""
    t, k = cands.shape
    parts = [cands]
    for i in range(1, OVERLAP_SHIFTS + 1):
        fwd = np.zeros_like(cands)
        fwd[i:] = cands[:-i]
        bwd = np.zeros_like(cands)
        bwd[:-i] = cands[i:]
        parts += [fwd, bwd]
    return np.concatenate(parts, axis=1)


# ---------------------------------------------------------------- refinement

def _refine(x: np.ndarray, fs: float, positions: np.ndarray, f0s: np.ndarray,
            f0_floor: float, f0_ceil: float, batch: int = 4096):
    """Instantaneous-frequency refinement of (position, f0) pairs.

    Returns (refined_f0, score) arrays of the same shape. Pairs are bucketed
    by their per-pair WORLD FFT class (2^ceil(log2(window+margin)) — the size
    GetMeanF0 itself would use); within a class, the 3-period Blackman
    windows are cached per unique integer half-length and the power/IF
    spectra are evaluated only at each pair's <=6 harmonic bins.
    """
    n_pairs = len(f0s)
    ref = np.zeros(n_pairs)
    score = np.zeros(n_pairs)
    live = f0s > 0
    if not live.any():
        return ref, score
    f0l = np.maximum(f0s[live], f0_floor)
    posl = positions[live]

    half = (1.5 * fs / f0l + 1.0).astype(np.int64)
    # WORLD sizes GetMeanF0's FFT per candidate (2^ceil(log2(window+margin)));
    # bucketing pairs by that per-pair class instead of padding everything to
    # the global max window both matches WORLD's resolution semantics and cuts
    # the dominant cost ~3x (high-f0 candidates vastly outnumber low-f0 ones
    # on the log-spaced channel grid but need 8-16x smaller buffers)
    fft_class = (2 ** np.ceil(np.log2(2 * (half + 1) + 2))).astype(np.int64)

    r_out = np.zeros(len(f0l))
    s_out = np.zeros(len(f0l))
    for fclass in np.unique(fft_class):
        cls_idx = np.nonzero(fft_class == fclass)[0]
        fft_size = int(fclass)
        max_half = int(half[cls_idx].max()) + 1
        base = np.arange(-max_half, max_half + 1)
        # The Blackman window depends only on the integer half-length: build
        # one window (and its derivative) per UNIQUE h instead of per pair
        uniq_h, inv_h = np.unique(half[cls_idx], return_inverse=True)
        hh = uniq_h[:, None]
        active_u = np.abs(base[None, :]) <= hh
        win_time = (2.0 * hh + 1.0) / fs
        t_rel = base[None, :] / fs
        w_lut = (0.42 + 0.5 * np.cos(2 * np.pi * t_rel / win_time)
                 + 0.08 * np.cos(4 * np.pi * t_rel / win_time))
        w_lut = np.where(active_u, w_lut, 0.0)
        dw_lut = np.zeros_like(w_lut)
        dw_lut[:, 1:-1] = -(w_lut[:, 2:] - w_lut[:, :-2]) / 2.0

        for b0 in range(0, len(cls_idx), batch):
            sl = cls_idx[b0:b0 + batch]
            origin = _round(posl[sl] * fs + 0.001)[:, None]
            seg_idx = np.clip(origin + base[None, :], 0, len(x) - 1)
            seg = x[seg_idx]
            w = w_lut[inv_h[b0:b0 + batch]]
            dw = dw_lut[inv_h[b0:b0 + batch]]

            main = np.fft.rfft(seg * w, n=fft_size, axis=1)
            diff = np.fft.rfft(seg * dw, n=fft_size, axis=1)
            n_bins = main.shape[1]

            f0b = f0l[sl]
            n_harm = np.minimum((fs / 2.0 / f0b).astype(np.int64), 6)
            num = np.zeros(len(f0b))
            den = np.zeros(len(f0b))
            dev = np.zeros(len(f0b))
            rows = np.arange(len(f0b))
            # WORLD GetMeanF0: refined f0 is the amplitude-weighted mean with
            # weights a·k (numerator sums a·IF, denominator a·k); the score is the
            # *mean* relative deviation of IF/k from the unrefined candidate over
            # all number_of_harmonics (leakage-dominated harmonics contribute one
            # bounded term each instead of vetoing the candidate outright).
            # Power/IF are evaluated ONLY at the <=6 harmonic bins each pair
            # reads — not over the full spectrum.
            for k in range(1, 7):
                idx = np.minimum(_round(f0b * k * fft_size / fs), n_bins - 1)
                m = main[rows, idx]
                d = diff[rows, idx]
                p = m.real ** 2 + m.imag ** 2
                numer = m.real * d.imag - m.imag * d.real
                inst_k = np.where(
                    p > 0,
                    idx * fs / fft_size + numer / np.maximum(p, SAFE) * fs / (2 * np.pi),
                    0.0)
                use = n_harm >= k
                a = np.sqrt(p) * use
                num += inst_k * a
                den += a * k
                dev += np.where(use, np.abs(inst_k / k - f0b) / f0b, 0.0)
            r = num / (den + SAFE)
            dev = dev / np.maximum(n_harm, 1)
            s = 1.0 / (dev + SAFE)
            bad = (r < f0_floor) | (r > f0_ceil) | (s < REFINE_SCORE_MIN)
            r[bad] = 0.0
            s[bad] = 0.0
            r_out[sl] = r
            s_out[sl] = s
    ref[live] = r_out
    score[live] = s_out
    return ref, score


def _remove_unreliable(cands: np.ndarray, scores: np.ndarray):
    """Zero candidates with no close (5%) candidate in either neighbor frame."""
    t, k = cands.shape
    if t < 3:
        return

    def min_rel_err(a, b):
        # a: [T, K] (this frame), b: [T, K'] (neighbor): min over the
        # neighbor's positive candidates of |a-b|/a, per entry.  The nearest
        # positive b (by value) also minimizes the relative error, so instead
        # of the O(T*K*K') broadcast (hundreds of MB at dense candidate
        # counts) sort all neighbors once with a per-row offset and binary-
        # search each a: the candidates flanking the insertion point are the
        # only minimizer candidates.
        t = a.shape[0]
        rows = np.arange(t)[:, None]
        off = 1e6  # >> f0_ceil, so rows never interleave in the sort
        b_flat = np.where(b > 0, b + rows * off, -np.inf).ravel()
        b_sorted = np.sort(b_flat)
        a_off = (a + rows * off).ravel()
        pos = np.searchsorted(b_sorted, a_off)
        a_flat = a.ravel()
        a_rows = np.broadcast_to(rows, a.shape).ravel()
        best = np.full(a_flat.shape, np.inf)
        for p in (pos - 1, pos):
            p = np.clip(p, 0, len(b_sorted) - 1)
            cand = b_sorted[p]
            finite = np.isfinite(cand)
            cand_safe = np.where(finite, cand, 0.0)
            ok = finite & (np.floor(cand_safe / off).astype(np.int64) == a_rows)
            val = cand_safe - a_rows * off
            rel = np.abs(a_flat - val) / np.maximum(a_flat, SAFE)
            best = np.minimum(best, np.where(ok, rel, np.inf))
        return best.reshape(a.shape)

    nxt = np.vstack([cands[1:], np.zeros((1, k))])
    prv = np.vstack([np.zeros((1, k)), cands[:-1]])
    err = np.minimum(min_rel_err(cands, nxt), min_rel_err(cands, prv))
    kill = (cands > 0) & (err > NEIGHBOR_MAX_REL_ERROR)
    cands[kill] = 0.0
    scores[kill] = 0.0


# ---------------------------------------------------------------- contour fix

def _boundary_list(f0: np.ndarray):
    """(start, end) index pairs of voiced runs (end exclusive)."""
    v = np.concatenate([[False], f0 > 0, [False]])
    st = np.nonzero(v[1:] & ~v[:-1])[0]
    ed = np.nonzero(~v[1:] & v[:-1])[0]
    return list(zip(st, ed))


def _fix_step1(f0_base: np.ndarray, allowed: float):
    out = np.zeros_like(f0_base)
    for i in range(2, len(f0_base)):
        if f0_base[i] == 0.0:
            continue
        ref = f0_base[i - 1] * 2 - f0_base[i - 2]
        if (abs((f0_base[i] - ref) / (SAFE + ref)) > allowed
                and abs((f0_base[i] - f0_base[i - 1]) / (SAFE + f0_base[i - 1])) > allowed):
            out[i] = 0.0
        else:
            out[i] = f0_base[i]
    return out


def _fix_step2(f0: np.ndarray, min_len: int):
    out = f0.copy()
    for st, ed in _boundary_list(f0):
        if ed - st < min_len:
            out[st:ed] = 0.0
    return out


def _select_best(target, cand_row):
    live = cand_row > 0
    if not live.any() or target <= 0:
        return 0.0, np.inf
    err = np.abs(cand_row - target) / target
    err[~live] = np.inf
    j = int(np.argmin(err))
    return cand_row[j], err[j]


def _extend(f0: np.ndarray, cands: np.ndarray):
    """Extend each voiced section outward along nearby candidates
    (WORLD FixStep3: ExtendF0 with a consecutive-miss limit)."""
    out = f0.copy()
    sections = _boundary_list(out)
    t = len(out)
    for st, ed in sections:
        # forward from ed-1
        cur = out[ed - 1]
        misses = 0
        for i in range(ed, t):
            if out[i] > 0:  # ran into the next section
                break
            best, err = _select_best(cur, cands[i])
            if err <= EXTEND_ALLOWED_RANGE:
                out[i] = best
                cur = best
                misses = 0
            else:
                misses += 1
                if misses >= EXTEND_MISS_LIMIT:
                    break
        # backward from st
        cur = out[st]
        misses = 0
        for i in range(st - 1, -1, -1):
            if out[i] > 0:
                break
            best, err = _select_best(cur, cands[i])
            if err <= EXTEND_ALLOWED_RANGE:
                out[i] = best
                cur = best
                misses = 0
            else:
                misses += 1
                if misses >= EXTEND_MISS_LIMIT:
                    break
    return out


def _smooth(f0: np.ndarray):
    """Zero-phase biquad low-pass of each voiced section (WORLD
    SmoothF0Contour coefficients), with 300-frame edge padding."""
    b = np.array([0.0078202080334971724, 0.015640416066994345, 0.0078202080334971724])
    a = np.array([1.0, -1.7347257688092754, 0.76600660094326412])
    from scipy.signal import filtfilt

    out = f0.copy()
    for st, ed in _boundary_list(f0):
        seg = f0[st:ed]
        if len(seg) < 12:
            continue
        padded = np.concatenate([np.full(300, seg[0]), seg, np.full(300, seg[-1])])
        sm = filtfilt(b, a, padded)
        out[st:ed] = sm[300:-300]
    return out


# ---------------------------------------------------------------- entrypoint

def harvest(
    x: np.ndarray,
    fs: int,
    *,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    frame_period: float = 5.0,
):
    """pyworld.harvest contract: returns (f0 [F], temporal_positions [F]) with
    F = floor(len(x)/fs*1000/frame_period) + 1; f0=0 marks unvoiced frames."""
    x = np.asarray(x, np.float64)
    y, actual_fs = _decimate(x, fs)
    y = y - y.mean()

    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    n_ch = int(1 + np.log2(adj_ceil / adj_floor) * CHANNELS_IN_OCTAVE)
    boundary_f0s = adj_floor * 2.0 ** ((np.arange(n_ch) + 1) / CHANNELS_IN_OCTAVE)

    n_grid = int(len(x) / fs * 1000 / FRAME_PERIOD_CANDIDATES_MS) + 1
    grid = np.arange(n_grid) * (FRAME_PERIOD_CANDIDATES_MS / 1000.0)

    raw = _raw_candidates(y, actual_fs, boundary_f0s, grid)
    cands = _official_candidates(raw)
    cands = _overlap_candidates(cands)

    # WORLD order: overlap first, then refine every (position, candidate)
    # pair — refining shifted copies at their *own* positions is what lets
    # noise-born candidates disagree with their neighbors and be removed
    t, k = cands.shape
    pos_pairs = np.repeat(grid, k)
    ref, score = _refine(y, actual_fs, pos_pairs, cands.ravel(), f0_floor, f0_ceil)
    cands = ref.reshape(t, k)
    scores = score.reshape(t, k)
    _remove_unreliable(cands, scores)

    base = np.where(scores.max(axis=1) > 0,
                    cands[np.arange(t), scores.argmax(axis=1)], 0.0)
    f0 = _fix_step1(base, FIX_STEP1_ALLOWED_RANGE)
    f0 = _fix_step2(f0, VOICE_RANGE_MINIMUM_MS)
    f0 = _extend(f0, cands)
    f0 = _fix_step2(f0, VOICE_RANGE_MINIMUM_MS)
    f0 = _smooth(f0)

    # sample the 1 ms contour at the requested frame period
    n_out = int(len(x) / fs * 1000 / frame_period) + 1
    positions = np.arange(n_out) * frame_period / 1000.0
    idx = np.minimum(_round(positions * 1000.0), len(f0) - 1)
    return f0[idx], positions
