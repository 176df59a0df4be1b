from mpmc_tpu_torch.text.normalize import (  # noqa: F401
    demojize,
    normalize_tweet,
    preprocess_arabic_tweet,
    remove_non_arabic_words,
)
