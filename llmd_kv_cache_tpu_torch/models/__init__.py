"""The paged Llama model and the MiniEngine serving pod."""
