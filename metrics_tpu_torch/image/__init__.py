from metrics_tpu_torch.image.fid import FID
from metrics_tpu_torch.image.inception import IS
from metrics_tpu_torch.image.kid import KID
from metrics_tpu_torch.image.lpip_similarity import LPIPS
from metrics_tpu_torch.image.psnr import PSNR
from metrics_tpu_torch.image.ssim import SSIM

__all__ = ["FID", "IS", "KID", "LPIPS", "PSNR", "SSIM"]
