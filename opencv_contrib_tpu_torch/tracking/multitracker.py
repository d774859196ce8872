"""MultiTracker facade (the tracking legacy API's cv::legacy::MultiTracker;
the port of opencv_contrib_tpu/tracking/multitracker.py): several
independent single-object trackers of mixed kinds, stepped together each
frame. The trackers are functional (state in, state out), so the facade
stores (kind, state, aux) and dispatches. Kinds: "mosse", "kcf", "csrt",
"medianflow", "mil", "boosting".

The twin splits a JAX key for each draw; here the draws come in the same
sequence from one `torch.Generator` on the tracker's device, seeded by
`seed`."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.tracking import boosting, correlation, csrt, medianflow, mil
from opencv_contrib_tpu_torch.tracking.correlation import _vec
from opencv_contrib_tpu_torch.utils.device import as_float

__all__ = ["MultiTracker"]


class MultiTracker:
    """add(kind, img, center_or_box, **kw) then update(img) each frame.
    Positions are (y, x) centres, except medianflow's, which takes a Box or
    (center, size). Images are float32 tensors on `device` (host arrays are
    moved there)."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self._trackers = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _next_key(self) -> torch.Generator:
        return self._gen

    def _img(self, img):
        img = as_float(img)
        return img if img.device == self.device else img.to(self.device)

    def add(self, kind: str, img, init, **kw):
        img = self._img(img)
        if kind == "mosse":
            st = correlation.mosse_init(img, init, **kw)
            aux = None
        elif kind == "kcf":
            st = correlation.kcf_init(img, init, **kw)
            aux = None
        elif kind == "csrt":
            st = csrt.csrt_init(img, init, **kw)
            aux = None
        elif kind == "medianflow":
            if isinstance(init, medianflow.Box):
                st = init
            else:
                center, size = init
                st = medianflow.Box(_vec(center, self.device), _vec(size, self.device))
            aux = None
        elif kind == "mil":
            bank = kw.pop("bank", None) or mil.make_feature_bank(self._next_key())
            st = mil.mil_init(img, init, self._next_key(), bank, **kw)
            aux = bank
        elif kind == "boosting":
            bank = kw.pop("bank", None) or boosting.make_feature_bank(self._next_key())
            st = boosting.boosting_init(img, init, self._next_key(), bank, **kw)
            aux = bank
        else:
            raise ValueError(f"unknown tracker kind: {kind}")
        self._trackers.append([kind, st, aux])
        return len(self._trackers) - 1

    def update(self, img, prev_img=None):
        """Step every tracker; medianflow needs the previous frame too.
        Returns a list of (y, x) centres (medianflow: the box centre)."""
        img = self._img(img)
        out = []
        for t in self._trackers:
            kind, st, aux = t
            if kind == "mosse":
                st, _ = correlation.mosse_update(st, img)
            elif kind == "kcf":
                st, _ = correlation.kcf_update(st, img)
            elif kind == "csrt":
                st, _ = csrt.csrt_update(st, img)
            elif kind == "medianflow":
                if prev_img is None:
                    raise ValueError("medianflow requires prev_img")
                st, _ = medianflow.medianflow_update(st, self._img(prev_img), img)
            elif kind == "mil":
                st, _ = mil.mil_update(st, img, self._next_key(), aux)
            elif kind == "boosting":
                st, _ = boosting.boosting_update(st, img, self._next_key(), aux)
            t[1] = st
            out.append(st.center)
        return out
