"""Loss and metric plots and the HTML results table.

The port's own copy of ``avsep_tpu/utils/viz.py``: ``plot_loss_metrics``
(reference ``viz.py:7-46``) writes loss.png / metrics_av.png /
metrics_ao.png from the history dict; ``HTMLVisualizer`` (reference
``viz.py:49-89``) renders a table of text / image / audio / video cells.
matplotlib is imported by the function; without it the plots are skipped
with one line, as the media layer skips videos without ffmpeg, so a train
loop's eval tick does not stop on a machine that lacks it.
"""

from __future__ import annotations

import os
from typing import List


def plot_loss_metrics(path: str, history: dict) -> None:
    try:
        import matplotlib
    except ImportError:
        print("[viz] matplotlib not found; skipping the loss and metric "
              "plots")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.plot(history["train"]["iter"], history["train"]["err"],
             color="b", label="training")
    if history["val_av"]["iter"]:
        plt.plot(history["val_av"]["iter"], history["val_av"]["err"],
                 color="c", label="val_av")
    if history["val_ao"]["iter"]:
        plt.plot(history["val_ao"]["iter"], history["val_ao"]["err"],
                 color="r", label="val_ao")
    plt.legend()
    fig.savefig(os.path.join(path, "loss.png"), dpi=200)
    plt.close(fig)

    for key in ("val_av", "val_ao"):
        if not history[key]["iter"]:
            continue
        fig = plt.figure()
        plt.plot(history[key]["iter"], history[key]["sdr"], label="SDR")
        plt.plot(history[key]["iter"], history[key]["sir"], label="SIR")
        plt.plot(history[key]["iter"], history[key]["sar"], label="SAR")
        plt.plot(history[key]["iter"], history[key]["si_sdr"],
                 label="SI-SDR")
        plt.legend()
        fig.savefig(os.path.join(path, f"metrics_{key.split('_')[1]}.png"),
                    dpi=200)
        plt.close(fig)


class HTMLVisualizer:
    """Row-of-cells HTML table writer (reference viz.py:49-89)."""

    def __init__(self, fn_html: str):
        self.fn_html = fn_html
        self.content = "<table>"
        self.content += """<style> table, th, td {border: 1px solid black;}
        </style>"""

    def add_header(self, elements: List[str]):
        self.content += "<tr>"
        for e in elements:
            self.content += f"<th>{e}</th>"
        self.content += "</tr>"

    def add_rows(self, rows):
        for row in rows:
            self.add_row(row)

    def add_row(self, elements):
        self.content += "<tr>"
        for e in elements:
            self.content += "<td>"
            if "text" in e:
                self.content += e["text"]
            if "image" in e:
                self.content += (f'<img src="{e["image"]}" '
                                 'style="max-height:256px;'
                                 'max-width:256px;">')
            if "audio" in e:
                self.content += (f'<audio controls><source src='
                                 f'"{e["audio"]}"></audio>')
            if "video" in e:
                self.content += (f'<video src="{e["video"]}" controls='
                                 '"controls" style="max-height:256px;'
                                 'max-width:256px;">')
            self.content += "</td>"
        self.content += "</tr>"

    def write_html(self):
        self.content += "</table>"
        with open(self.fn_html, "w") as f:
            f.write(self.content)
