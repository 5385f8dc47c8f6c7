"""Training CLI of the port (the flags of tools/train.py, the JAX
package's, less --quant_config and --profiler_options):

    python -m paddle3d_tpu_torch.tools.train --config configs/...yml \
        [--iters N] [--resume] [--do_eval] [--device cpu]

Trains on the card unless --device cpu is given; nothing falls back to the
CPU. Checkpoints go to --save_dir/checkpoints/iter_N/{model,optimizer,
lr_scheduler}.pt.
"""
import argparse
import random

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Model training")
    parser.add_argument("--config", dest="cfg", required=True, type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--save_dir", type=str, default="output")
    parser.add_argument("--save_interval", type=int, default=1000)
    parser.add_argument("--log_interval", type=int, default=10)
    parser.add_argument("--keep_checkpoint_max", type=int, default=5)
    parser.add_argument("--do_eval", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--ema_decay", type=float, default=None)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="dataloader worker threads")
    return parser.parse_args(argv)


def main(args):
    import torch

    from paddle3d_tpu_torch.apis import Config, Trainer
    from paddle3d_tpu_torch.utils.logger import logger

    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    cfg = Config(path=args.cfg, batch_size=args.batch_size, iters=args.iters,
                 epochs=args.epochs, learning_rate=args.learning_rate,
                 device=args.device)
    logger.info("Config loaded:\n{}".format(cfg))

    trainer = Trainer(
        model=cfg.model,
        optimizer=cfg.optimizer,
        lr_scheduler=cfg.lr_scheduler,
        iters=cfg.iters,
        epochs=cfg.epochs,
        train_dataset=cfg.train_dataset,
        val_dataset=cfg.val_dataset if args.do_eval else None,
        batch_size=cfg.batch_size,
        save_dir=args.save_dir,
        save_interval=args.save_interval,
        log_interval=args.log_interval,
        keep_checkpoint_max=args.keep_checkpoint_max,
        do_eval=args.do_eval,
        resume=args.resume,
        ema_decay=args.ema_decay,
        ema_cfg=cfg.ema_cfg,
        amp_cfg=cfg.amp_cfg,
        grad_clip_norm=cfg.dic.get("optimizer", {}).get("grad_clip_norm"),
        seed=args.seed or 0,
        dataloader_fn={"num_workers": args.num_workers},
    )
    trainer.train()


if __name__ == "__main__":
    main(parse_args())
