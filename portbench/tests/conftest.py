import torch

# several test workers share the host's cores
torch.set_num_threads(2)
