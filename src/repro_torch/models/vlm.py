"""VLM family (llava-next-34b): dense GQA backbone + stub anyres frontend.

Port of ``repro.models.vlm``. The modality frontend is a STUB: the caller
supplies precomputed patch embeddings (B, num_patches, 1024) which a
learned ``vision_proj`` maps into the token stream ahead of the text
tokens. The backbone is exactly the dense decoder (transformer.py) —
decode/serving is identical once the prefix is in the KV cache, and the
loss skips the patch positions (``transformer.loss_fn``). The dry-run
entries of the reference's list are not ported yet, as in
transformer.py.
"""
from repro_torch.models import transformer as tf

Model = tf.Model
param_shapes = tf.param_shapes
param_logical = tf.param_logical
init_params = tf.init_params
param_count = tf.param_count
active_param_count = tf.active_param_count
forward = tf.forward
loss_fn = tf.loss_fn
make_train_step = tf.make_train_step
prefill = tf.prefill
decode_step = tf.decode_step
cache_shapes = tf.cache_shapes
cache_logical = tf.cache_logical
