"""The port's counterparts of the repository's `scripts/`: the checkpoint
exporter and the three-stage curriculum script.

    python -m dh3d_tpu_torch.scripts.package_checkpoint --ckpt LOGDIR \
        --out STEM
    python -m dh3d_tpu_torch.scripts.train_demo_curriculum --pool DIR \
        --out DIR [--seeds S ...] [--steps S1 S2 S3] [--device cuda|cpu]
"""
