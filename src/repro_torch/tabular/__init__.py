from .datasets import (TabularDataset, make_dataset, partition_full_copy,
                       partition_iid, partition_label_skew,
                       partition_malicious, partition_quantity_skew)
from .encoders import (ColumnSpec, DecodePlan, EncodePlan, LabelEncoder,
                       SpanInfo, TableEncoders, fit_centralized_encoders,
                       make_decode_plan, make_encode_plan)
from .metrics import avg_jsd, avg_wd, similarity_report
from .vgm import (NEG_INF, VGMParams, decode_column, encode_column, fit_vgm,
                  kernel_log_weights, merge_client_vgms,
                  merge_client_vgms_table, pack_vgm_params, sample_vgm)
