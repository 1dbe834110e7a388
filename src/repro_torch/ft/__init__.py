from .elastic import ElasticPlan, plan_elastic_mesh, HostFailure, run_with_restarts
from .straggler import StragglerDetector, StragglerReport
