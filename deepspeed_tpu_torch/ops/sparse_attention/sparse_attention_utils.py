"""Helpers for adapting models to block-sparse attention.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``
(reference deepspeed/ops/sparse_attention/sparse_attention_utils.py:
extend_position_embedding:19, update_tokenizer_model_max_length:67,
pad_to_block_size:126, unpad_sequence_output:180), on tensors.
"""
import torch
import torch.nn.functional as F


class SparseAttentionUtils:
    """Utilities for integrating sparse attention into transformer models."""

    @staticmethod
    def extend_position_embedding(weights, max_position,
                                  num_reserved_positions=0):
        """Tile position-embedding ``weights`` (orig_pos, emb) up to
        ``max_position`` rows (bert tiles the whole table, roberta keeps
        its 2 reserved rows via ``num_reserved_positions=2``)."""
        reserved = weights[:num_reserved_positions]
        body = weights[num_reserved_positions:]
        original = body.shape[0]
        if max_position <= original:
            raise ValueError(
                f"new max position {max_position} must exceed the original "
                f"{original}")
        multiples = -(-max_position // original)  # ceil: cover every position
        extended = torch.cat([body] * multiples, dim=0)[:max_position]
        return torch.cat([reserved, extended], dim=0)

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Raise a HF tokenizer's max length."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def pad_to_block_size(block_size, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Right-pad sequence inputs to a multiple of ``block_size``.
        Returns ``(pad_len, padded tensors...)`` in the argument order;
        absent inputs come back as None. Padding positions get
        ``pad_token_id`` / mask 0 / type 0, and position ids continue
        counting. ``inputs_embeds`` are padded with the embedding of
        ``pad_token_id`` when ``model_embeddings`` (a (vocab, emb) table)
        is given, else zeros."""
        ref = input_ids if input_ids is not None else inputs_embeds
        assert ref is not None, "need input_ids or inputs_embeds"
        seq_len = ref.shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size

        def pad_2d(x, value):
            return None if x is None else F.pad(x, (0, pad_len), value=value)

        if pad_len:
            input_ids = pad_2d(input_ids, pad_token_id)
            attention_mask = pad_2d(attention_mask, 0)
            token_type_ids = pad_2d(token_type_ids, 0)
            if position_ids is not None:
                tail = position_ids[:, -1:] + torch.arange(
                    1, pad_len + 1, dtype=position_ids.dtype,
                    device=position_ids.device)[None, :]
                position_ids = torch.cat([position_ids, tail], dim=1)
            if inputs_embeds is not None:
                b, _, e = inputs_embeds.shape
                if model_embeddings is not None:
                    fill = model_embeddings[pad_token_id].to(
                        inputs_embeds.dtype).expand(b, pad_len, e)
                else:
                    fill = inputs_embeds.new_zeros((b, pad_len, e))
                inputs_embeds = torch.cat([inputs_embeds, fill], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Drop the padded tail added by :meth:`pad_to_block_size`."""
        if pad_len:
            sequence_output = sequence_output[:, :-pad_len]
        return sequence_output
