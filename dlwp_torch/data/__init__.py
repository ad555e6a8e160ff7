"""Host data containers and samplers, and the device-resident sampler
(port of ``dlwp_tpu.data``)."""

from dlwp_torch.data.dataset import PredictorDataset
from dlwp_torch.data.device_sampler import DeviceSeriesSampler
from dlwp_torch.data.sampler import SamplesSampler, SeriesSampler, device_prefetch

__all__ = ["DeviceSeriesSampler", "PredictorDataset", "SamplesSampler",
           "SeriesSampler", "device_prefetch"]
