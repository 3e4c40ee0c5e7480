from metrics_tpu_torch.functional.image.gradients import image_gradients
from metrics_tpu_torch.functional.image.psnr import psnr
from metrics_tpu_torch.functional.image.ssim import ssim

__all__ = ["image_gradients", "psnr", "ssim"]
