"""Evaluation CLI of the port (the flags of tools/evaluate.py, the JAX
package's):

    python -m paddle3d_tpu_torch.tools.evaluate --config cfg.yml \
        [--model output/checkpoints/iter_N] [--device cpu]

--model is a checkpoint directory (its model.pt) or a model.pt file, a
torch state dict as the port's Trainer saves it. Serves the config's
val_dataset on the card unless --device cpu is given, and logs the
metric's dict.
"""
import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Model evaluation")
    parser.add_argument("--config", dest="cfg", required=True, type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--model", type=str, default=None,
                        help="checkpoint dir or model.pt file")
    parser.add_argument("--batch_size", type=int, default=None)
    return parser.parse_args(argv)


def main(args) -> dict:
    import torch

    from paddle3d_tpu_torch.apis import Config, Trainer
    from paddle3d_tpu_torch.apis.checkpoint import Checkpoint
    from paddle3d_tpu_torch.utils.logger import logger

    cfg = Config(path=args.cfg, batch_size=args.batch_size,
                 device=args.device)
    model = cfg.model
    if args.model is not None:
        path = args.model
        if os.path.isdir(path):
            path = os.path.join(path, Checkpoint.PARAMS_FILE)
        model.load_state_dict(torch.load(path, map_location=args.device,
                                         weights_only=True))
        logger.info("Loaded weights from {}".format(path))

    trainer = Trainer(model=model, optimizer=cfg.optimizer, iters=0,
                      val_dataset=cfg.val_dataset,
                      batch_size=cfg.batch_size)
    metrics = trainer.evaluate()
    logger.info("Evaluation results: {}".format(metrics))
    return metrics


if __name__ == "__main__":
    main(parse_args())
