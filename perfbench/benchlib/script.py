"""The one generator of editing traffic: a seeded script of slider ticks.

A traffic file (``perfbench/traffic/<name>.json``) holds only parameters:

- ``masks``: the regional masks the set-up adds, each ``{"name", "kind",
  "coverage"}`` (kinds: ``scene.mask_logits``);
- ``main``: the ranges ``[lo, hi]`` of the main mask's ``vignette``,
  ``lens_distortion`` and ``sharpness`` at the start (``[0, 0]`` keeps a
  stage off);
- ``nonzero``: sliders that step over 0, so that their stage runs on every
  tick of every seed;
- ``curve_points``: control points of the (brightness, hue, saturation,
  lightness) curves every mask gets (0: the slot keeps its default);
- ``sliders``: per slider ``[lo, hi, min_step, max_step]``;
- ``curve_step``: ``[min_step, max_step]`` of a control point's move;
  ``curve_band``: how far the brightness and the hue curves' points stay
  from the diagonal (a curve's steepness, and with it how far one step of a
  65536-entry table moves a value, stays that of a curve a user draws);
- ``mix``: ``[[kind, weight], ...]`` of tick kinds (whole weights):
  ``tone``, ``wb``, ``vignette``, ``curve``, ``lens_distortion``,
  ``sharpness``; ``alternate: true`` cycles through them in order instead;
- ``tick_masks``: ``"all"`` (a tick moves one slider of a random mask) or
  ``"main"``;
- ``capture_within``: the sampled ticks whose renders are checked are drawn
  from the window's first ``capture_within`` ticks (its last tick is always
  checked too).

Ticks are drags: each moves one slider from where it is by a step drawn in
``[min_step, max_step]``, reflected at the ends of the slider's range.
Curve ticks move one interior control point of any of the four curves.
Every seed gives the same work: the tick kinds, the masks they move, the
tone and white-balance sliders and the curve slots are dealt from decks
(``Deck``), so each round of a deck holds each item as often as the mix
says, in an order the seed shuffles.
"""

from __future__ import annotations

import copy

import numpy as np

TONE = ("exposure", "contrast", "shadow", "highlight", "black", "white")
WB = ("temperature", "tint")
CURVE_SLOTS_MOVED = (0, 1, 2, 3)
GAIN_RANGE = {2: (20000, 49000),   # saturation gain 0.61 .. 1.50 by hue
              3: (28000, 37500)}   # lightness gain 0.85 .. 1.14 by hue


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _curve(r: np.random.Generator, slot: int, n: int, band):
    """A seeded curve of ``n`` control points for ``slot``. Hue is a turn,
    so the hue remap keeps its ends at (0, 0) and (65535, 65535) and the
    saturation and lightness gains end where they start: each stays
    continuous across the seam where hue wraps, as the hue curves of an
    editor's HSL panel are."""
    if n == 0:
        return None
    xs = np.linspace(0, 65535, n).round().astype(np.int64)
    xs[1:-1] += r.integers(-2000, 2001, size=n - 2)
    if slot == 0:    # brightness: a tone curve around the diagonal
        ys = np.clip(xs + r.integers(-band[0], band[0] + 1, size=n), 0, 65535)
    elif slot == 1:  # hue: a remap around the identity
        ys = np.clip(xs + r.integers(-band[1], band[1] + 1, size=n), 0, 65535)
        ys[0], ys[-1] = 0, 65535
    else:            # saturation or lightness gain by hue
        ys = r.integers(*GAIN_RANGE[slot], size=n)
        ys[-1] = ys[0]
    return [int(v) for v in xs], [int(v) for v in ys]


class Deck:
    """Items dealt in rounds: each round is the items in an order shuffled
    by ``r``."""

    def __init__(self, items, r: np.random.Generator):
        self.items, self.r, self.hand = list(items), r, []

    def deal(self):
        if not self.hand:
            self.hand = [self.items[i] for i in self.r.permutation(len(self.items))]
        return self.hand.pop()


def _reflect(v, lo, hi):
    if v > hi:
        v = 2 * hi - v
    if v < lo:
        v = 2 * lo - v
    return min(hi, max(lo, v))


class Script:
    """The session's initial edit state and its ticks, from a seed."""

    def __init__(self, traffic: dict, seed: int, true_hw):
        self.t = traffic
        self.r = _rng(seed, 1)
        r0 = _rng(seed, 2)
        sl = traffic["sliders"]
        masks = []
        for _ in range(1 + len(traffic.get("masks", []))):
            p = {k: self._value(k, r0.uniform(*sl[k][:2])) for k in TONE + WB}
            p["curves"] = [_curve(r0, s, n, traffic["curve_band"])
                           for s, n in enumerate(traffic["curve_points"])]
            masks.append(p)
        main = {k: self._value(k, r0.uniform(lo, hi)) for k, (lo, hi) in traffic["main"].items()}
        self.state = {"true_hw": list(true_hw), "masks": masks, "main": main}
        self.initial = copy.deepcopy(self.state)
        self.kinds = [k for k, _ in traffic["mix"]]
        r = self.r
        self.decks = {"kind": Deck([k for k, n in traffic["mix"] for _ in range(int(n))], r),
                      "mask": Deck(range(len(masks)), r),
                      "tone": Deck(TONE, r), "wb": Deck(WB, r)}
        for k, p in enumerate(masks):
            self.decks["curve", k] = Deck(
                [s for s in CURVE_SLOTS_MOVED if p["curves"][s] is not None], r)
        self.ticks: list = []

    def _value(self, name, v, direction=1.0):
        """A slider value as the editor takes it: EV as a float, the rest
        whole numbers; ``nonzero`` sliders step over 0."""
        if name == "exposure":
            return float(v)
        v = int(round(v))
        if v == 0 and name in self.t.get("nonzero", ()):
            v = 1 if direction > 0 else -1
        return v

    def _step(self, value, name):
        lo, hi, smin, smax = self.t["sliders"][name]
        step = self.r.uniform(smin, smax) * (1 if self.r.random() < 0.5 else -1)
        return self._value(name, _reflect(value + step, lo, hi), step)

    def next(self, kind: str | None = None):
        """The next tick ``(mask index, kind, payload)``, applied to the
        state; ``kind`` forces its kind (the set-up's warm-up)."""
        r = self.r
        if kind is None:
            if self.t.get("alternate"):
                kind = self.kinds[len(self.ticks) % len(self.kinds)]
            else:
                kind = self.decks["kind"].deal()
        main_only = (self.t.get("tick_masks", "all") == "main"
                     or kind in ("vignette", "lens_distortion", "sharpness"))
        k = 0 if main_only else int(self.decks["mask"].deal())
        p = self.state["masks"][k]
        main = self.state["main"]
        if kind in ("tone", "wb"):
            names = TONE if kind == "tone" else WB
            name = self.decks[kind].deal()
            p[name] = self._step(p[name], name)
            payload = tuple(p[n] for n in names)
        elif kind in ("vignette", "lens_distortion", "sharpness"):
            main[kind] = self._step(main[kind], kind)
            payload = main[kind]
        elif kind == "curve":
            s = self.decks["curve", k].deal()
            xs, ys = p["curves"][s]
            i = 1 + int(r.integers(len(xs) - 2))
            if s in GAIN_RANGE:
                lo, hi = GAIN_RANGE[s]
            else:
                band = self.t["curve_band"][s]
                lo, hi = max(0, xs[i] - band), min(65535, xs[i] + band)
            smin, smax = self.t["curve_step"]
            ys = list(ys)
            step = r.uniform(smin, smax) * (1 if r.random() < 0.5 else -1)
            ys[i] = int(round(_reflect(ys[i] + step, lo, hi)))
            p["curves"][s] = (list(xs), ys)
            payload = (s, list(xs), ys)
        else:
            raise ValueError(f"unknown tick kind {kind!r}")
        tick = (k, kind, payload)
        self.ticks.append(tick)
        return tick

    def state_after(self, n_ticks: int) -> dict:
        """The edit state after the first ``n_ticks`` ticks (replayed from
        the initial state)."""
        state = copy.deepcopy(self.initial)
        for k, kind, payload in self.ticks[:n_ticks]:
            p = state["masks"][k]
            if kind == "tone":
                p.update(zip(TONE, payload))
            elif kind == "wb":
                p.update(zip(WB, payload))
            elif kind == "curve":
                s, xs, ys = payload
                p["curves"][s] = (list(xs), list(ys))
            else:
                state["main"][kind] = payload
        return state

    def capture_ticks(self, seed: int) -> list[int]:
        """Window tick indices whose renders are checked, drawn from the
        seed (the last tick is added when the window closes)."""
        n = int(self.t["capture_within"])
        return sorted(int(i) for i in _rng(seed, 3).choice(n, size=2, replace=False))
