"""GAN training of the codec: balancer, optimizers, schedulers, gradient
clipping, the train step and the epoch loop (`python -m
hilcodec_tpu_torch.train`)."""
