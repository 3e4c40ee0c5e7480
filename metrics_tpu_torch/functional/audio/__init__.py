from metrics_tpu_torch.functional.audio.pit import pit, pit_permutate
from metrics_tpu_torch.functional.audio.si_sdr import si_sdr
from metrics_tpu_torch.functional.audio.si_snr import si_snr
from metrics_tpu_torch.functional.audio.snr import snr

__all__ = ["pit", "pit_permutate", "si_sdr", "si_snr", "snr"]
