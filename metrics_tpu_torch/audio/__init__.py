from metrics_tpu_torch.audio.pit import PIT
from metrics_tpu_torch.audio.si_sdr import SI_SDR
from metrics_tpu_torch.audio.si_snr import SI_SNR
from metrics_tpu_torch.audio.snr import SNR

__all__ = ["PIT", "SI_SDR", "SI_SNR", "SNR"]
