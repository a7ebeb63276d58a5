"""Loss and metric plots.

The port's own copy of ``plot_loss_metrics`` from ``avsep_tpu/utils/
viz.py`` (reference ``viz.py:7-46``): loss.png / metrics_av.png /
metrics_ao.png from the history dict.  matplotlib is imported by the
function.  The JAX module's ``HTMLVisualizer`` has no caller there or here
and is not copied.
"""

from __future__ import annotations

import os


def plot_loss_metrics(path: str, history: dict) -> None:
    import matplotlib
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
