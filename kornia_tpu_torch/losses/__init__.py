"""Task losses (SSIM, PSNR): the part of ``kornia_tpu.losses`` ported so far."""
