"""Training: anchor and roi targets, OHEM, losses, the train step, the
SGD recipe, checkpoints, and `init_model`/`train_net`."""
