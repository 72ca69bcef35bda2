"""Plot consumers (counterpart of sdr_tpu/io/plot.py): line and filled
plots of one block, their frequency axes, and the scrolling waterfall.

Hosts with the card are headless, so the plots render PNGs (matplotlib,
imported only to render: the axes and the waterfall's text rows need
none) or, for the waterfall, text rows for a terminal.  The waterfall
keeps the latest ``rows`` spectral rows, scrolling like the reference's
texture ring.
"""

from __future__ import annotations

import os

import numpy as np

from sdr_tpu_torch.io.files import _host
from sdr_tpu_torch.ops.fftops import waterfall_image

__all__ = ["plot_line", "plot_fill", "Waterfall", "zero_axis",
           "centered_axis"]


def zero_axis(n: int, fs: float = 1.0) -> np.ndarray:
    """Frequency axis [0, fs) of ``n`` bins."""
    return np.arange(n) * (fs / n)


def centered_axis(n: int, fs: float = 1.0) -> np.ndarray:
    """DC-centred frequency axis [-fs/2, fs/2) of ``n`` bins, for
    fftshifted spectra."""
    return (np.arange(n) - n // 2) * (fs / n)


def _figure(title, xlabel, ylabel):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 5))
    if title:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return plt, fig, ax


def plot_line(y, filename: str, x=None, title: str = "",
              xlabel: str = "sample", ylabel: str = "") -> None:
    """Save a line plot of one block ``y`` (an array or a tensor) against
    ``x`` (default: the sample index) as a PNG."""
    plt, fig, ax = _figure(title, xlabel, ylabel)
    y = _host(y)
    ax.plot(_host(x) if x is not None else np.arange(len(y)), y,
            linewidth=0.8)
    fig.savefig(filename, dpi=100)
    plt.close(fig)


def plot_fill(y, filename: str, x=None, title: str = "",
              xlabel: str = "frequency", ylabel: str = "power") -> None:
    """Save a filled plot of one block ``y`` (a spectrum) against ``x``
    (default: the bin index) as a PNG."""
    plt, fig, ax = _figure(title, xlabel, ylabel)
    y = _host(y)
    ax.fill_between(_host(x) if x is not None else np.arange(len(y)), y,
                    color="#3070b0")
    fig.savefig(filename, dpi=100)
    plt.close(fig)


class Waterfall:
    """Scrolling waterfall: feed spectral rows with :meth:`push`,
    :meth:`save` renders the current window, :meth:`ansi_rows` renders
    rows as terminal text."""

    # characters of increasing ink for the terminal renderer
    _RAMP = " .:-=+*#%@"

    def __init__(self, bins: int, rows: int = 512, db: bool = True):
        self.buf = np.zeros((rows, bins), dtype=np.float32)
        self.db = db
        self._n = 0

    def push(self, row) -> None:
        """Append rows ``[k, bins]`` (or one row ``[bins]``); the oldest
        scroll out."""
        row = np.asarray(row, dtype=np.float32)
        if row.ndim == 1:
            row = row[None, :]
        k = row.shape[0]
        self._n += k
        if k >= self.buf.shape[0]:      # one push larger than the window
            self.buf = row[-self.buf.shape[0]:].copy()
            return
        self.buf = np.roll(self.buf, -k, axis=0)
        self.buf[-k:] = row

    def save(self, filename: str, atomic: bool = False) -> None:
        """Render the current window to a PNG.  ``atomic=True`` writes a
        temporary file and renames it over ``filename``, so a viewer
        polling the path never reads a half-written image."""
        target = f"{filename}.tmp" if atomic else filename
        waterfall_image(self.buf, target, db=self.db, ylabel="time (rows)")
        if atomic:
            os.replace(target, filename)

    def ansi_rows(self, rows, cols: int = 80, lo_db: float = -80.0,
                  hi_db: float = 0.0) -> list:
        """Spectral rows as terminal text lines, one string a row: the
        bins max-pooled to ``cols`` characters, the level in dB between
        ``lo_db`` and ``hi_db`` as ink."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        img = 20 * np.log10(np.maximum(rows, 1e-12)) if self.db else rows
        n = img.shape[1]
        idx = np.linspace(0, n, cols + 1).astype(int)
        pooled = np.stack([img[:, idx[i]:max(idx[i + 1], idx[i] + 1)].max(
            axis=1) for i in range(cols)], axis=1)
        t = np.clip((pooled - lo_db) / (hi_db - lo_db), 0.0, 1.0)
        levels = (t * (len(self._RAMP) - 1)).astype(int)
        return ["".join(self._RAMP[v] for v in line) for line in levels]
