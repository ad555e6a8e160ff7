"""Host data containers, samplers and preprocessing, the barotropic
archive source, and the device-resident sampler (port of
``dlwp_tpu.data``)."""

from dlwp_torch.data.barotropic_archive import BarotropicArchiveSource
from dlwp_torch.data.dataset import PredictorDataset
from dlwp_torch.data.device_sampler import DeviceSeriesSampler
from dlwp_torch.data.preprocessing import (
    DataSource,
    Preprocessor,
    streaming_mean_std,
)
from dlwp_torch.data.sampler import SamplesSampler, SeriesSampler, device_prefetch

__all__ = ["BarotropicArchiveSource", "DataSource", "DeviceSeriesSampler",
           "PredictorDataset", "Preprocessor", "SamplesSampler",
           "SeriesSampler", "device_prefetch", "streaming_mean_std"]
