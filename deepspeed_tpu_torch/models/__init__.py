from . import gpt2
from .gpt2 import GPT2Model, make_gpt2_model
