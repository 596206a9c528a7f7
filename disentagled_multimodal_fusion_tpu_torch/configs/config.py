"""The sections of ``disentagled_multimodal_fusion_tpu/configs/config.yaml``
that the port reads, as Python (the port needs no YAML parser).
``tests/test_torch_serve.py`` holds this copy equal to the YAML."""

CONFIG = {
    "experiment": {
        "seeds": [0, 1, 2, 3, 4],
        "normal_datasets": ["CUB", "HandWritten", "PIE", "Scene"],
        "conflict_datasets": ["CUB", "HandWritten", "PIE", "Scene"],
    },
    "dataloader": {
        "batch_size": 100,
        "num_workers": 0,
    },
    "data": {
        "split": {"train_frac": 0.8},
        "conflict": {
            "addNoise": False,
            "sigma": 0.5,
            "ratio_noise": 0.0,
            "addConflict": True,
            "ratio_conflict": 1.0,
        },
    },
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
    "logging": {
        "datasets_excel_path": "logs/dataset_analysis.xlsx",
    },
}
