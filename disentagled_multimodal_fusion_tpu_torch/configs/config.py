"""The sections of ``disentagled_multimodal_fusion_tpu/configs/config.yaml``
that the port reads, as Python (the port needs no YAML parser).
``tests/test_torch_serve.py`` holds this copy equal to the YAML."""

CONFIG = {
    "optim": {
        "dataset_lr": {
            "CalTech": 0.0003,
            "Scene": 0.01,
            "CUB": 0.003,
            "HandWritten": 0.003,
            "PIE": 0.003,
        },
    },
    "dmvae": {
        "dropout": 0,
        "a": 1.0e-5,
        "hidden_dim": 512,
        "embed_dim": 200,
        "lr": 0.0001,
        "num_epochs": 100,
    },
    "probes": {
        "dropout_p": 0.1,
        "annealing_start": 50,
        "model_epochs": 200,
        "model_hidden_dim": [128],
        "input_dim": 200,
    },
}
