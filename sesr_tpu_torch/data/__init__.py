"""The data path of the port (numpy only): datasets and the Bayer
conversions behind them."""

from sesr_tpu_torch.data.datasets import (RawBayerDataset, SRFolderDataset,
                                          SyntheticDataset, TrainBayerDataset,
                                          TrainMatDataset, task_pair_from_image)

__all__ = ["RawBayerDataset", "SRFolderDataset", "SyntheticDataset", "TrainBayerDataset",
           "TrainMatDataset", "task_pair_from_image"]
