from .dataset import ParticleDataset
