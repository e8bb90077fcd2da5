from . import bert, gpt2
from .bert import BertModel, make_bert_model, make_bert_squad_model
from .gpt2 import GPT2Model, make_gpt2_model
