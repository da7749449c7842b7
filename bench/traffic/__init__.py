"""The one request generator: a traffic mix's parameters -> a schedule.

A mix (``traffic/<mix>.json``) fixes the *sizes* its requests take; the
seed draws only their order, their token ids and their image embeddings.
So every seed runs the same multiset of shapes, and two runs of one seed
run the same requests.

``text``: either ``{"lengths": [...]}``, a fixed set of token counts, or
``{"min", "max", "strata", "round_to"}``, a length drawn log-uniform over
``[min, max]`` and stratified: the midpoints, in log space, of ``strata``
equal slices of the range (rounded up to ``round_to``).  ``image``:
``{"sizes": [[width, height], ...]}`` in pixels, or absent (text only); an
image's positions are the ones LLaVA-NeXT's anyres tiling gives it under
the configuration's ``image_grid_pinpoints`` and vision tower
(:func:`anyres_positions`).  A request's shape is one of the product of
the image positions with the text lengths.  ``in_flight``: the requests a
closed loop keeps issued (the next is sent while the last runs).

One cycle holds each shape once; the schedule repeats cycles, each in its
own order.  Within a cycle the shapes go in pairs, the i-th smallest with
the i-th largest, and the seed shuffles the pairs and the order inside
each: a window that ends inside a cycle then still holds about the
cycle's mix of sizes, so the seed moves the work done per second little.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["Request", "Schedule", "shapes", "stratified_lengths",
           "anyres_positions"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One request: ``n_image`` image embeddings then ``n_text`` tokens,
    read from the run's pools at ``image_offset`` and ``text_offset``."""
    index: int
    n_image: int
    n_text: int
    image_offset: int
    text_offset: int

    @property
    def positions(self) -> int:
        return self.n_image + self.n_text


def stratified_lengths(lo: int, hi: int, strata: int,
                       round_to: int = 1) -> List[int]:
    """The midpoints in log space of ``strata`` equal slices of
    ``[lo, hi]``, rounded up to a multiple of ``round_to`` and kept within
    ``[lo, hi]`` (a log-uniform draw over the range, stratified)."""
    if not (1 <= lo <= hi and strata >= 1 and round_to >= 1):
        raise ValueError(f"bad length range {lo}..{hi}, {strata} strata, "
                         f"round_to {round_to}")
    span = math.log(hi) - math.log(lo)
    out = []
    for j in range(strata):
        x = math.exp(math.log(lo) + (j + 0.5) / strata * span)
        x = -(-int(math.ceil(x)) // round_to) * round_to
        out.append(min(max(x, lo), hi))
    return out


def _best_resolution(width: int, height: int,
                     pinpoints: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """The (height, width) of ``pinpoints`` that keeps most of the image's
    pixels once it is scaled to fit, the least waste on a tie (LLaVA-NeXT's
    ``select_best_resolution``)."""
    best, most, least_waste = None, -1, math.inf
    for ph, pw in pinpoints:
        scale = min(pw / width, ph / height)
        kept = min(int(width * scale) * int(height * scale), width * height)
        waste = ph * pw - kept
        if kept > most or (kept == most and waste < least_waste):
            best, most, least_waste = (ph, pw), kept, waste
    return best


def anyres_positions(width: int, height: int, cfg: Dict) -> int:
    """The image positions LLaVA-NeXT gives a ``width`` x ``height`` image:
    the base tile's patches, then the patches of the grid of tiles chosen
    from ``image_grid_pinpoints``, with the rows (or columns) that only pad
    the image's aspect ratio taken off, and one newline a row."""
    vision = cfg["vision_config"]
    side = vision["image_size"] // vision["patch_size"]
    ph, pw = _best_resolution(width, height, cfg["image_grid_pinpoints"])
    rows = side * (ph // vision["image_size"])
    cols = side * (pw // vision["image_size"])
    if width / height > cols / rows:
        kept = int(round(height * (cols / width), 7))
        rows -= 2 * ((rows - kept) // 2)
    else:
        kept = int(round(width * (rows / height), 7))
        cols -= 2 * ((cols - kept) // 2)
    return side * side + rows * cols + rows


def shapes(mix: Dict, cfg: Dict) -> List[Tuple[int, int]]:
    """Every (image positions, text tokens) shape of one cycle."""
    text = mix["text"]
    lengths = list(text["lengths"]) if "lengths" in text else \
        stratified_lengths(text["min"], text["max"], text["strata"],
                           text.get("round_to", 1))
    image = mix.get("image")
    images = [0] if image is None else [
        anyres_positions(w, h, cfg) for w, h in image["sizes"]]
    return [(i, t) for i in images for t in lengths]


class Schedule:
    """The requests of one run, in order, from a mix, the configuration
    it is served on, and a seed.

    ``text_pool`` and ``image_pool`` are the sizes of the pools the
    program's inputs are cut from; each request reads a window of each at
    an offset the seed draws, so no two requests share their inputs
    (nothing a cache keyed on content could reuse)."""

    def __init__(self, mix: Dict, cfg: Dict, seed: int, text_pool: int,
                 image_pool: int):
        self.mix = mix
        self.cycle = shapes(mix, cfg)
        self.in_flight = int(mix["in_flight"])
        self.text_pool, self.image_pool = text_pool, image_pool
        longest_text = max(t for _, t in self.cycle)
        longest_image = max(i for i, _ in self.cycle)
        if longest_text > text_pool or longest_image > image_pool:
            raise ValueError("a request is longer than its input pool")
        self._rng = np.random.default_rng(int(seed) % 2**64)
        self._requests: List[Request] = []

    def _extend(self) -> None:
        rng = self._rng
        by_size = sorted(self.cycle, key=lambda s: (s[0] + s[1], s))
        n = len(by_size)
        pairs = [[by_size[i], by_size[n - 1 - i]] if i != n - 1 - i
                 else [by_size[i]] for i in range((n + 1) // 2)]
        order: List[Tuple[int, int]] = []
        for k in rng.permutation(len(pairs)):
            pair = pairs[k]
            order += pair if rng.random() < 0.5 else pair[::-1]
        for n_image, n_text in order:
            self._requests.append(Request(
                index=len(self._requests), n_image=n_image, n_text=n_text,
                image_offset=int(rng.integers(
                    0, self.image_pool - n_image + 1)),
                text_offset=int(rng.integers(
                    0, self.text_pool - n_text + 1))))

    def __getitem__(self, i: int) -> Request:
        while i >= len(self._requests):
            self._extend()
        return self._requests[i]

    def first_cycle(self) -> Sequence[Request]:
        return [self[i] for i in range(len(self.cycle))]
