"""Host-side visualization: dictionary grids and reconstruction panels.

Counterpart of ``onmf_ontf_ndl_tpu/utils/viz.py``: the same seven figure
functions with the same signatures and layouts. Each takes tensors on any
device or arrays and moves each tensor to the host once. matplotlib is
imported inside each function, with the Agg backend when the figure only
goes to ``save_path`` (``show=False``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["display_dictionary", "display_network_dictionary",
           "display_recons_panel", "display_second_dictionary",
           "display_errors_comparison", "display_dictionary_color_combine",
           "show_array"]


def _host(x) -> np.ndarray:
    """A host array of a tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot(save_path, show):
    import matplotlib

    if save_path and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, save_path, show):
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return save_path


def show_array(arr, *, cmap: str | None = None,
               save_path: str | None = None, show: bool = False):
    """Single-array imshow; ``save_path`` writes a file, ``show`` opens the
    interactive window."""
    plt = _pyplot(save_path, show)
    fig, ax = plt.subplots(nrows=1, ncols=1, figsize=(4, 4.5),
                           subplot_kw={"xticks": [], "yticks": []})
    ax.imshow(_host(arr), cmap=cmap)
    return _finish(plt, fig, save_path, show)


def _grid_dims(r: int, grid_shape=None):
    if grid_shape is not None:
        return grid_shape
    rows = int(round(np.sqrt(r)))
    cols = rows if rows * rows == r else rows + 1
    return rows, cols


def display_dictionary(W, patch_size: int, *, is_color: bool = True,
                       title: str | None = None, save_path: str | None = None,
                       grid_shape=None, show: bool = False):
    """Grid of dictionary atoms as (k, k[,3]) patches."""
    plt = _pyplot(save_path, show)
    W = _host(W)
    k = patch_size
    rows, cols = _grid_dims(W.shape[1], grid_shape)
    fig, axs = plt.subplots(nrows=rows, ncols=cols, figsize=(6, 6),
                            subplot_kw={"xticks": [], "yticks": []})
    for ax, i in zip(np.atleast_1d(axs).flat, range(rows * cols)):
        if i >= W.shape[1]:
            ax.axis("off")
            continue
        if is_color:
            patch = W[:, i].reshape(k, k, 3)
            ax.imshow(patch / max(patch.max(), 1e-12))
        else:
            ax.imshow(W[:, i].reshape(k, k), cmap="gray",
                      interpolation="nearest")
    plt.suptitle(title or f"Dictionary learned from {k}x{k} patches",
                 fontsize=14)
    fig.subplots_adjust(0.08, 0.02, 0.92, 0.85, 0.08, 0.23)
    return _finish(plt, fig, save_path, show)


def display_network_dictionary(W, k: int, *, title: str | None = None,
                               save_path: str | None = None,
                               show: bool = False):
    """Grid of k x k motif-adjacency atoms, black = 1 (gray_r)."""
    plt = _pyplot(save_path, show)
    W = _host(W)
    rows, cols = _grid_dims(W.shape[1])
    fig, axs = plt.subplots(nrows=rows, ncols=cols, figsize=(5, 5),
                            subplot_kw={"xticks": [], "yticks": []})
    for ax, j in zip(np.atleast_1d(axs).flat, range(W.shape[1])):
        ax.imshow(W[:, j].reshape(k, k), cmap="gray_r",
                  interpolation="nearest")
    if title:
        plt.suptitle(title)
    fig.subplots_adjust(left=0.1, bottom=0.1, right=0.9, top=0.9,
                        wspace=0.2, hspace=0)
    return _finish(plt, fig, save_path, show)


def display_recons_panel(W_list, A_recons_list, originals, patch_size: int,
                         *, save_path: str | None = None,
                         title: str | None = None, fig_size=(11, 6),
                         show: bool = False):
    """Side-by-side panel: per training stage, the reconstruction (top)
    and the dictionary grid (bottom), with the originals in the first
    column. Colour is detected per dictionary: (3k^2, r) atoms render as
    RGB patches, (k^2, r) as greyscale."""
    plt = _pyplot(save_path, show)
    import matplotlib.gridspec as gridspec

    k = patch_size
    n_stage = len(W_list)
    fig = plt.figure(figsize=fig_size, constrained_layout=False)
    outer = gridspec.GridSpec(nrows=2, ncols=n_stage + 1, wspace=0.2,
                              hspace=0.2)
    # originals in column 0
    for row, img in enumerate(originals[:2]):
        ax = fig.add_subplot(outer[row, 0].subgridspec(1, 1)[0, 0])
        ax.imshow(_host(img))
        ax.set_xticks([]); ax.set_yticks([])
    for j, (W, rec) in enumerate(zip(W_list, A_recons_list)):
        ax = fig.add_subplot(outer[0, j + 1].subgridspec(1, 1)[0, 0])
        ax.imshow(_host(rec))
        ax.set_xticks([]); ax.set_yticks([])
        W = _host(W)
        rows, cols = _grid_dims(W.shape[1])
        inner = outer[1, j + 1].subgridspec(rows, cols, wspace=0.2,
                                            hspace=0.02)
        is_color = W.shape[0] == 3 * k * k
        for i in range(min(rows * cols, W.shape[1])):
            ax = fig.add_subplot(inner[i // cols, i % cols])
            if is_color:
                patch = W[:, i].reshape(k, k, 3)
                ax.imshow(patch / max(patch.max(), 1e-12),
                          interpolation="nearest")
            else:
                ax.imshow(W[:, i].reshape(k, k), cmap="gray",
                          interpolation="nearest")
            ax.set_xticks([]); ax.set_yticks([])
    if title:
        plt.suptitle(title, fontsize=20)
    return _finish(plt, fig, save_path, show)


def display_second_dictionary(H, patch_size: int, *,
                              save_path: str | None = None,
                              show: bool = False):
    """Heatmap of a second (e.g. channel) factor matrix."""
    plt = _pyplot(save_path, show)
    fig, ax = plt.subplots(nrows=1, ncols=1, figsize=(6, 2),
                           subplot_kw={"xticks": [], "yticks": []})
    ax.imshow(_host(H))
    plt.tight_layout()
    plt.suptitle(
        f"Dictionary learned from patches of size {patch_size}",
        fontsize=16)
    return _finish(plt, fig, save_path, show)


def display_errors_comparison(errors_by_label: dict, *,
                              total_updates: float | None = None,
                              normalize: float = 1.0,
                              xlabel: str = "", ylabel: str = "",
                              save_path: str | None = None,
                              show: bool = False):
    """Overlaid error traces ({label: 1-D array}). ``total_updates``
    rescales each trace's x-axis to a common span; ``normalize`` divides
    the error values."""
    plt = _pyplot(save_path, show)
    fig, ax = plt.subplots(nrows=1, ncols=1, figsize=(4, 4))
    for label, e in errors_by_label.items():
        e = _host(e)
        if total_updates is not None and len(e) > 0:
            x = total_updates * np.arange(len(e)) / len(e)
        else:
            x = np.arange(len(e))
        ax.plot(x, e / normalize, label=str(label))
    ax.legend()
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    plt.tight_layout()
    return _finish(plt, fig, save_path, show)


def display_dictionary_color_combine(W, H, patch_size: int, *,
                                     save_path: str | None = None,
                                     show: bool = False):
    """Combine a spatial dictionary W (k^2, r) with a channel dictionary
    H (3, r) into colour atoms and display the grid."""
    plt = _pyplot(save_path, show)
    W = _host(W)
    H = _host(H)
    k = patch_size
    img_dict = W[:, None, :] * H[None, :, :]        # (k^2, 3, r)
    rows, cols = _grid_dims(W.shape[1])
    fig, axs = plt.subplots(nrows=rows, ncols=cols, figsize=(6, 6),
                            subplot_kw={"xticks": [], "yticks": []})
    for ax, i in zip(np.atleast_1d(axs).flat, range(W.shape[1])):
        patch = img_dict[:, :, i].reshape(k, k, 3)
        ax.imshow(patch / max(patch.max(), 1e-12))
    plt.suptitle(f"Combined color dictionary ({k}x{k})", fontsize=14)
    return _finish(plt, fig, save_path, show)
