"""Host data containers and samplers (port of ``dlwp_tpu.data``)."""

from dlwp_torch.data.dataset import PredictorDataset
from dlwp_torch.data.sampler import SamplesSampler, SeriesSampler, device_prefetch

__all__ = ["PredictorDataset", "SamplesSampler", "SeriesSampler",
           "device_prefetch"]
