"""Copy of photon_tpu/io/schemas.py (framework-free; the port does not import it).

Avro schemas compatible with the reference's data formats.

Field names/types mirror the reference's 12 .avsc files
(photon-avro-schemas/src/main/avro/, inventory SURVEY.md §2.4) so that data
and model files interoperate; the schemas are declared here as Python dicts
consumed by photon_tpu_torch.io.avro. Namespaces are preserved so Java readers
resolve the records.
"""

NAME_TERM_VALUE_SCHEMA = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

FEATURE_SCHEMA = {
    "type": "record",
    "name": "FeatureAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_SCHEMA = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_SCHEMA}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

RESPONSE_PREDICTION_SCHEMA = {
    "type": "record",
    "name": "SimplifiedResponsePrediction",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
    ],
}
# FeatureAvro must be defined inline on first use for self-contained files:
RESPONSE_PREDICTION_SCHEMA["fields"][1]["type"]["items"] = FEATURE_SCHEMA

BAYESIAN_LINEAR_MODEL_SCHEMA = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_SCHEMA}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

SCORING_RESULT_SCHEMA = {
    "type": "record",
    "name": "ScoringResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

FEATURE_SUMMARIZATION_SCHEMA = {
    "type": "record",
    "name": "FeatureSummarizationResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}

LATENT_FACTOR_SCHEMA = {
    "type": "record",
    "name": "LatentFactorAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
    ],
}
