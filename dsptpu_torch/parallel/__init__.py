"""Sharded DSP on torch.distributed (dsptpu's parallel/): meshes,
process-group setup and the simulated hosts, and the sharded ops."""

from .mesh import make_mesh, default_mesh
from .ops import (shard_fir, shard_fftfilt, shard_welch, shard_sosfilt,
                  shard_filtfilt,
                  shard_stft_pow, shard_spectrogram,
                  shard_mt_spectrogram, shard_mt_cross_power_spectra,
                  shard_mt_coherence, shard_resample, compact_shards,
                  shard_time)
from .distributed import (init_distributed, global_mesh, simulate_hosts,
                          weak_scaling_efficiency, HostPool, Sharded)
