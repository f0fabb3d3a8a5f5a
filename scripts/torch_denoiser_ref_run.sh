#!/bin/sh
# Reference-scale denoiser training on the PyTorch port, on CUDA device 0:
# the flags of scripts/denoiser_ref_run.sh. 33 poses x 16 patches of 256^2
# cut from 512^2 renders (2 spp noisy against 20,000 spp ground truth, the
# reference's collect_data.py workload), trained with the reference recipe
# (L1, SGD with Nesterov momentum, plateau, batch 5) for thousands of
# epochs; per-epoch JSONL metrics and checkpoints every 200 epochs land in
# results/<time>_ref_scale/. It takes hours; it is not a gate.
set -x
exec python -m pathtrace_tpu_torch.train \
  --name ref_scale \
  --size 512 \
  --poses 33 \
  --patch-size 256 \
  --patches-per-image 16 \
  --spp-train 2 \
  --spp-gt 20000 \
  --epochs "${EPOCHS:-3000}" \
  --batch 5 \
  --scan-epochs \
  --ckpt-every 200 \
  --pose-mode interior \
  --device 0
