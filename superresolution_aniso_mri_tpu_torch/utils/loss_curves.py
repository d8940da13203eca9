"""Loss-curve plotting from the npz archives (port of
``superresolution_aniso_mri_tpu/utils/loss_curves.py``; matplotlib is
imported inside the function).

Reference: kwatsch/show_loss_curves.py:7+ and
kwatsch/base_trainer.py:473-487 — three stacked panels (reconstruction,
extra image loss, latent mse), train vs test.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def show_loss_curves(iters, losses_train: Dict, losses_test: Dict,
                     iter_range: Optional[slice] = None,
                     save_path: Optional[str] = None):
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if iter_range is None:
        iter_range = slice(0, len(iters), None)
    panels = [("loss_ae_dist", "Reconstruction"),
              ("loss_ae_dist_extra", "Extra image loss"),
              ("loss_latent_1", "latent mse")]
    fig, axes = plt.subplots(len(panels), 1, figsize=(10, 10))
    for ax, (key, title) in zip(np.atleast_1d(axes), panels):
        x = np.asarray(iters)[iter_range]
        for arr, color, label in (
                (losses_train.get(key), "b", "tr"),
                (losses_test.get(key), "r", "te")):
            if arr is None or not len(arr):
                continue
            y = np.asarray(arr)[iter_range]
            n = min(len(x), len(y))   # both truncated to the COMMON
            ax.plot(x[:n], y[:n], c=color, label=label)  # sliced length
        ax.set_title(title)
        ax.legend(loc="best")
    fig.tight_layout(rect=[0.03, 0.03, 0.97, 0.97])
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
    else:
        plt.show()
    return fig


def show_experiment_losses(path_to_exper: str,
                           save_path: Optional[str] = None):
    from ..train.trainer import Trainer

    iters, tr, te = Trainer.load_losses(path_to_exper)
    return show_loss_curves(iters, tr, te, save_path=save_path)
