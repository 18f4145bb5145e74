"""Loss-curve plotting CLI of the PyTorch port (a copy of
``spsg_tpu/cli/plot.py``; reference torch/plot.py:10-160): reads log.csv /
log_val.csv + args.txt from a training run's directory (the port's train CLI
writes the JAX package's files) and plots the weighted loss components and
the occupancy IoU. Host only: pandas and matplotlib.

  python -m spsg_tpu_torch.cli.plot --run_dir ./logs   # -> ./logs/loss.png
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", "--log_path", dest="run_dir", required=True,
                   help="training run dir (log.csv, args.txt); --log_path is "
                   "the reference spelling (plot.py:11)")
    p.add_argument("--output", default="", help="output png (default <run_dir>/loss.png)")
    p.add_argument("--name", default="",
                   help="experiment name used in the figure title "
                   "(reference plot.py:13)")
    p.add_argument("--val", action=argparse.BooleanOptionalAction, default=True,
                   help="include the validation curves (reference plot.py:12)")
    p.add_argument("--max_iter", type=int, default=0)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    run_args = {}
    args_path = os.path.join(args.run_dir, "args.txt")
    if os.path.isfile(args_path):
        with open(args_path) as f:
            run_args = json.load(f)

    df = pd.read_csv(os.path.join(args.run_dir, "log.csv"))
    if args.max_iter:
        df = df[df["iter"] <= args.max_iter]

    weights = {
        "train_loss(occ)": run_args.get("weight_occ_loss", 1.0),
        "train_loss(sdf)": run_args.get("weight_sdf_loss", 0.1),
        "train_loss(depth)": run_args.get("weight_depth_loss", 1.0),
        "train_loss(color)": run_args.get("weight_color_loss", 1.0),
        "train_loss(semantic)": run_args.get("weight_semantic_loss", 0.1),
        "train_loss(gen)": run_args.get("weight_discgen_loss", 0.005),
        "train_loss(style)": run_args.get("weight_style_loss", 0.0),
        "train_loss(content)": run_args.get("weight_content_loss", 0.0),
    }

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    if args.name:
        fig.suptitle(args.name)
    it = df["iter"]
    ax1.plot(it, df["train_loss(total)"], label="total", lw=2, color="black")
    for col, w in weights.items():
        if col in df.columns and w > 0:
            series = df[col].to_numpy()
            m = series >= 0
            if m.any():
                ax1.plot(it[m], series[m] * w, label=f"{col} (x{w:g})", alpha=0.7)
    ax1.set_ylabel("weighted loss")
    ax1.legend(fontsize=7, ncol=3)
    ax1.grid(alpha=0.3)

    iou = df["train_iou(occ)"].to_numpy()
    m = iou >= 0
    ax2.plot(it[m], iou[m], label="train iou(occ)", color="tab:green")
    val_path = os.path.join(args.run_dir, "log_val.csv")
    if args.val and os.path.isfile(val_path):
        dv = pd.read_csv(val_path)
        viou = dv["val_iou(occ)"].to_numpy()
        mv = viou >= 0
        ax2.plot(dv["iter"][mv], viou[mv], label="val iou(occ)", color="tab:orange")
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("occupancy IoU")
    ax2.legend()
    ax2.grid(alpha=0.3)

    out = args.output or os.path.join(args.run_dir, "loss.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
