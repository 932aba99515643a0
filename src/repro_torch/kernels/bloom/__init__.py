from .ops import bloom_insert, bloom_insert_ref, make_filter_words
