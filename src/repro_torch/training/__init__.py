from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.optimizer import AdamWState, adamw
from repro_torch.training.schedule import cosine, wsd
from repro_torch.training.train_step import make_eval_step, make_train_step
