from repro_torch.train.optimizer import OptConfig
from repro_torch.train.data import DataConfig, MarkovMotifDataset
from repro_torch.train.loop import train, make_train_step

__all__ = ["OptConfig", "DataConfig", "MarkovMotifDataset", "train", "make_train_step"]
