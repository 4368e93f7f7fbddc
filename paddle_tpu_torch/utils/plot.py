"""Training-curve plotting (port of ``paddle_tpu/utils/plot.py``, a
copy; matplotlib is imported only when a figure is drawn) — parity
with python/paddle/v2/plot/plot.py Ploter (used throughout the book
examples' event handlers). Headless-safe: matplotlib loads lazily with
the Agg backend, DISABLE_PLOT=True turns plotting into a no-op while
data collection keeps working (so event handlers run unchanged in CI).
"""
import os

__all__ = ["Ploter", "PlotData"]


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(float(value))

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    """Ploter("train cost", "test cost"); .append(title, step, value);
    .plot(path) saves a figure (or no-ops under DISABLE_PLOT=True)."""

    def __init__(self, *args):
        self._titles = args
        self._data = {title: PlotData() for title in args}

    @property
    def _disabled(self):
        return os.environ.get("DISABLE_PLOT") == "True"

    def append(self, title, step, value):
        if title not in self._data:
            raise KeyError(f"unknown curve {title!r}; declared: "
                           f"{list(self._titles)}")
        self._data[title].append(step, value)

    def data(self, title):
        return self._data[title]

    def plot(self, path=None):
        if self._disabled:
            return
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        titles = []
        for title in self._titles:
            data = self._data[title]
            if data.step:
                titles.append(title)
                plt.plot(data.step, data.value)
        plt.legend(titles, loc="upper left")
        if path is not None:
            plt.savefig(path)
        else:
            # reference parity: display inline when possible (notebook),
            # else plt.show() (a no-op on Agg, but never silent loss of
            # a requested save — pass ``path`` to keep the figure)
            try:
                from IPython import display
                display.clear_output(wait=True)
                display.display(plt.gcf())
            except ImportError:
                plt.show()
        plt.gcf().clear()

    def reset(self):
        for data in self._data.values():
            data.reset()
