"""The models: the Llama family (its dense-slot and paged-KV decode
paths too), GPT-2 and Mixtral, the HF checkpoint loaders of all five
families, and the numpy parameter converter."""
