"""OCR heads: character classification and HMM Viterbi / beam-search
decoding (the port of opencv_contrib_tpu/text/ocr.py).

Reference anchors (text):
- src/ocr_hmm_decoder.cpp: OCRHMMDecoder::run, per-segment character
  classifier posteriors and HMM language-model decoding (Viterbi), lexicon
  constrained transitions (createOCRHMMTransitionsTable)
- src/ocr_beamsearch_decoder.cpp: OCRBeamSearchDecoder::run, beam search
  over per-window classifier posteriors

Glyph classification is one NCC product against the template bank. The
twin's `lax.scan`s over time are loops over T here, on the device: a
Viterbi step is a max and a first-occurrence argmax over a dense (C, C)
table, a beam step a stable sort of the (B, C) candidates (ties by the
lower index, as `lax.top_k`). Nothing is read back before the decoded
states. The built-in 5x7 glyph bank is also the synthetic-text renderer.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import resize
from opencv_contrib_tpu_torch.utils.device import as_float

# ---------------------------------------------------------------------------
# 5x7 glyph bank (A-Z, 0-9): rows of 5 chars, '#' = ink
# ---------------------------------------------------------------------------

_GLYPHS = {
    "A": [" ### ", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "B": ["#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "],
    "C": [" ####", "#    ", "#    ", "#    ", "#    ", "#    ", " ####"],
    "D": ["###  ", "#  # ", "#   #", "#   #", "#   #", "#  # ", "###  "],
    "E": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"],
    "F": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "],
    "G": [" ####", "#    ", "#    ", "#  ##", "#   #", "#   #", " ### "],
    "H": ["#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "I": [" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "J": ["  ###", "   # ", "   # ", "   # ", "   # ", "#  # ", " ##  "],
    "K": ["#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"],
    "M": ["#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"],
    "N": ["#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"],
    "O": [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "P": ["#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "],
    "Q": [" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"],
    "R": ["#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"],
    "S": [" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "],
    "T": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "U": ["#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "V": ["#   #", "#   #", "#   #", "#   #", "#   #", " # # ", "  #  "],
    "W": ["#   #", "#   #", "#   #", "# # #", "# # #", "## ##", "#   #"],
    "X": ["#   #", "#   #", " # # ", "  #  ", " # # ", "#   #", "#   #"],
    "Y": ["#   #", "#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  "],
    "Z": ["#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"],
    "0": [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    "1": ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "2": [" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"],
    "3": [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],
    "4": ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    "5": ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    "6": [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],
    "7": ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    "8": [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],
    "9": [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
}

VOCAB = "".join(sorted(_GLYPHS.keys()))
GLYPH_H, GLYPH_W = 7, 5


def glyph_bank() -> np.ndarray:
    """(C, 7, 5) float32 glyph templates in VOCAB order."""
    out = np.zeros((len(VOCAB), GLYPH_H, GLYPH_W), np.float32)
    for i, ch in enumerate(VOCAB):
        for r, row in enumerate(_GLYPHS[ch]):
            for c, v in enumerate(row):
                out[i, r, c] = 1.0 if v == "#" else 0.0
    return out


def render_text(s: str, scale: int = 2, spacing: int = 1, pad: int = 2,
                noise: float = 0.0, rng=None) -> np.ndarray:
    """Rasterize a string with the built-in bank (the synthetic data source
    for training/evaluating the OCR heads)."""
    bank = glyph_bank()
    cols = []
    gap = np.zeros((GLYPH_H, spacing), np.float32)
    for ch in s.upper():
        if ch == " ":
            cols.append(np.zeros((GLYPH_H, GLYPH_W), np.float32))
        else:
            cols.append(bank[VOCAB.index(ch)])
        cols.append(gap)
    img = np.concatenate(cols[:-1] if spacing else cols, axis=1)
    img = np.kron(img, np.ones((scale, scale), np.float32))
    img = np.pad(img, pad)
    if noise and rng is not None:
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    return img


# ---------------------------------------------------------------------------
# Character classification (NCC against the bank)
# ---------------------------------------------------------------------------


def classify_glyphs(patches: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Log-posteriors (N, C) of (N, 7, 5) patches against the bank by
    normalized cross-correlation -> softmax (the role of the reference's
    character classifier)."""
    P = as_float(patches).reshape(patches.shape[0], -1)
    B = as_float(bank).to(P.device).reshape(bank.shape[0], -1)
    P = P - P.mean(1, keepdim=True)
    P = P / torch.clamp(torch.linalg.vector_norm(P, dim=1, keepdim=True), min=1e-9)
    Bn = B - B.mean(1, keepdim=True)
    Bn = Bn / torch.clamp(torch.linalg.vector_norm(Bn, dim=1, keepdim=True), min=1e-9)
    return torch.log_softmax((P @ Bn.T) * 10.0, dim=-1)


def segment_characters(img, thresh: float = 0.3) -> torch.Tensor:
    """Split a text-line image into per-character patches by the ink column
    projection (the word segmentation OCRHMMDecoder expects); returns (N, 7,
    5) patches on the image's device. The blurred image is read to the host
    once for the runs; the crops are resized where the image lies."""
    img = as_float(img)
    sm = filters.gaussian_blur(img, 0.8).cpu().numpy()
    ink = sm > thresh
    colmass = ink.sum(0)
    on = colmass > max(1, 0.12 * colmass.max())
    # runs of on-columns
    edges = np.diff(on.astype(np.int8))
    starts = list(np.where(edges == 1)[0] + 1)
    ends = list(np.where(edges == -1)[0] + 1)
    if on[0]:
        starts = [0] + starts
    if on[-1]:
        ends = ends + [len(on)]
    # split runs that merged two glyphs (wider than 1.6x the median run)
    widths = [e - s for s, e in zip(starts, ends)]
    if widths:
        med = float(np.median(widths))
        split_s, split_e = [], []
        for s, e in zip(starts, ends):
            if e - s > 1.6 * med and e - s >= 6:
                mid_lo = s + (e - s) // 4
                mid_hi = e - (e - s) // 4
                cut = mid_lo + int(np.argmin(colmass[mid_lo:mid_hi]))
                split_s += [s, cut]
                split_e += [cut, e]
            else:
                split_s.append(s)
                split_e.append(e)
        starts, ends = split_s, split_e
    patches = []
    for s, e in zip(starts, ends):
        rows = np.where(ink[:, s:e].any(1))[0]
        if len(rows) == 0:
            continue
        patches.append(resize(img[int(rows[0]):int(rows[-1]) + 1, int(s):int(e)], (GLYPH_H, GLYPH_W)))
    if not patches:
        return torch.zeros((0, GLYPH_H, GLYPH_W), device=img.device)
    return torch.stack(patches)


# ---------------------------------------------------------------------------
# HMM decoding
# ---------------------------------------------------------------------------


def transitions_from_lexicon(words, smoothing: float = 1e-3) -> torch.Tensor:
    """Bigram transition log-probs (C, C) from a word list (a CPU tensor;
    cv::text::createOCRHMMTransitionsTable)."""
    C = len(VOCAB)
    counts = np.full((C, C), smoothing, np.float64)
    for w in words:
        w = [c for c in w.upper() if c in VOCAB]
        for a, b in zip(w[:-1], w[1:]):
            counts[VOCAB.index(a), VOCAB.index(b)] += 1.0
    P = counts / counts.sum(1, keepdims=True)
    return torch.as_tensor(np.log(P).astype(np.float32))


def viterbi_decode(emissions: torch.Tensor, transitions: torch.Tensor) -> torch.Tensor:
    """MAP state sequence of an HMM (OCRHMMDecoder::run's decoding step):
    emissions (T, C) log-probs, transitions (C, C) log-probs. Returns (T,)
    int64 states."""
    transitions = transitions.to(emissions.device)
    delta = emissions[0]
    backs = []
    for t in range(1, emissions.shape[0]):
        scores = delta[:, None] + transitions + emissions[t][None, :]
        delta = scores.amax(dim=0)
        backs.append(torch.argmax(scores, dim=0))  # the first of equal maxima, as jnp.argmax
    state = torch.argmax(delta)
    states = [state]
    for back in reversed(backs):
        state = back[state]
        states.append(state)
    return torch.stack(states[::-1])


def _stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest of 1-D x, ties by the lower index."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def beam_search_decode(emissions: torch.Tensor, transitions: torch.Tensor, beam: int = 8):
    """Beam-search decoding (OCRBeamSearchDecoder::run): keeps the `beam`
    best partial paths a step; returns ((T,) best path, score)."""
    transitions = transitions.to(emissions.device)
    T, C = emissions.shape
    scores, last = _stable_topk(emissions[0], beam)
    paths = torch.zeros((beam, T), dtype=torch.int64, device=emissions.device)
    paths[:, 0] = last
    for t in range(1, T):
        cand = scores[:, None] + transitions[last] + emissions[t][None, :]  # (B, C)
        scores, top_i = _stable_topk(cand.reshape(-1), beam)
        last = top_i % C
        paths = paths[torch.div(top_i, C, rounding_mode="floor")]
        paths[:, t] = last
    best = torch.argmax(scores)
    return paths[best], scores[best]


def ocr_hmm(img, lexicon=None, use_beam: bool = False, beam: int = 8) -> str:
    """One-call OCR of a rendered text line (OCRHMMDecoder::run /
    OCRBeamSearchDecoder::run): segment -> classify -> decode, where the
    image lies; the states are read back once."""
    patches = segment_characters(img)
    if patches.shape[0] == 0:
        return ""
    dev = patches.device
    em = classify_glyphs(patches, torch.as_tensor(glyph_bank(), device=dev))
    if lexicon:
        trans = transitions_from_lexicon(lexicon).to(dev)
    else:
        trans = torch.zeros((len(VOCAB), len(VOCAB)), device=dev)
    if use_beam:
        states, _ = beam_search_decode(em, trans, beam=beam)
    else:
        states = viterbi_decode(em, trans)
    return "".join(VOCAB[int(s)] for s in states.cpu().numpy())
