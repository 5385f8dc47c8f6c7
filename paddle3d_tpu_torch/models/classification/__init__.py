from .paconv import PAConv, ScoreNet, assign_score_withk
