// On-robot bridge: 500 Hz loop between the low-level motor interface and
// the UDP-multicast bus the Python agent speaks.
//
// Native counterpart of the reference's only C++ component
// (reference: go1_gym_deploy/unitree_legged_sdk_bin/lcm_position.cpp:
// Custom::RobotControl at :131-210, init at :63, main at :213-236): reads
// motor q/qd/tau + IMU + foot forces + RC from the robot, republishes them
// on leg_control_data / state_estimator_data / rc_command, receives
// pd_plustau_targets, and writes PD targets to the motors behind two safety
// layers equivalent to Unitree's PositionLimit + PowerProtect(level 9)
// (:206-207).
//
// The Unitree SDK is proprietary and absent from this tree, so the motor
// interface is a small virtual class:
//   * UnitreeRobot  — the stub to fill in with unitree_legged_sdk calls
//                     when building on the Go1's Jetson;
//   * SimRobot      — a self-contained second-order joint simulator used
//                     for loopback integration tests on any machine
//                     (run: ./udp_bridge --sim).
//
// Build: walk_these_ways_tpu_torch/deploy/bridge.py (g++ -O2 -std=c++17
// -pthread, into build/; -DWTW_BUS_PORT=<port> for another bus port).
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <thread>

#include "wire.h"

namespace wtw {

static const double kDt = 0.002;  // 500 Hz (reference lcm_position.cpp:47)

// Joint position limits in SDK order (FR, FL, RR, RL) x (hip, thigh, calf)
// — the PositionLimit safety layer.
static const float kQLow[3] = {-0.802851f, -1.047197f, -2.696533f};
static const float kQHigh[3] = {0.802851f, 4.188790f, -0.916297f};
static const float kTauMax = 33.5f;
// PowerProtect-style cap: limit commanded torque fraction of max
static const float kPowerLevel = 0.9f;  // level 9 of 10

struct LowState {
  float q[12], qd[12], tau[12];
  float rpy[3], quat[4], gyro[3], acc[3];
  float foot_force[4];
  RcCommand rc;
};

struct MotorCmd {
  float q_des[12], qd_des[12], kp[12], kd[12], tau_ff[12];
};

class RobotInterface {
 public:
  virtual ~RobotInterface() = default;
  virtual void read_state(LowState *out) = 0;
  virtual void write_cmd(const MotorCmd &cmd) = 0;
};

// -- loopback simulator for integration tests -------------------------------
class SimRobot : public RobotInterface {
 public:
  SimRobot() {
    memset(&state_, 0, sizeof(state_));
    memset(&cmd_, 0, sizeof(cmd_));
    state_.quat[0] = 1.0f;
    for (int i = 0; i < 4; i++) state_.foot_force[i] = 250.0f;  // standing
  }

  void read_state(LowState *out) override {
    // integrate a unit-inertia joint under the commanded PD torque
    for (int i = 0; i < 12; i++) {
      float tau = cmd_.kp[i] * (cmd_.q_des[i] - state_.q[i]) +
                  cmd_.kd[i] * (cmd_.qd_des[i] - state_.qd[i]) +
                  cmd_.tau_ff[i];
      float inertia = 0.05f;
      state_.qd[i] += (float)(kDt * tau / inertia);
      state_.qd[i] *= 0.995f;  // viscous loss
      state_.q[i] += (float)(kDt * state_.qd[i]);
      state_.tau[i] = tau;
    }
    *out = state_;
  }

  void write_cmd(const MotorCmd &cmd) override { cmd_ = cmd; }

 private:
  LowState state_;
  MotorCmd cmd_;
};

// -- Unitree SDK stub --------------------------------------------------------
// Fill these in with unitree_legged_sdk (UDP to 192.168.123.10) when
// building on the robot; the rest of the bridge is identical.
class UnitreeRobot : public RobotInterface {
 public:
  UnitreeRobot() {
    fprintf(stderr,
            "UnitreeRobot: link against unitree_legged_sdk on the Go1 "
            "(see reference lcm_position.cpp:63-129 for the mapping)\n");
  }
  void read_state(LowState *out) override { memset(out, 0, sizeof(*out)); }
  void write_cmd(const MotorCmd &) override {}
};

class Bridge {
 public:
  Bridge(RobotInterface *robot) : robot_(robot), bus_() {
    memset(&cmd_, 0, sizeof(cmd_));
    running_ = true;
  }

  void apply_safety(MotorCmd *cmd, const LowState &st) {
    for (int i = 0; i < 12; i++) {
      int j = i % 3;  // hip/thigh/calf within each leg
      // PositionLimit: clamp targets into the joint range
      if (cmd->q_des[i] < kQLow[j]) cmd->q_des[i] = kQLow[j];
      if (cmd->q_des[i] > kQHigh[j]) cmd->q_des[i] = kQHigh[j];
      // PowerProtect: cap the implied torque
      float tau = cmd->kp[i] * (cmd->q_des[i] - st.q[i]) +
                  cmd->kd[i] * (cmd->qd_des[i] - st.qd[i]) + cmd->tau_ff[i];
      float cap = kTauMax * kPowerLevel;
      if (tau > cap) cmd->tau_ff[i] -= (tau - cap);
      if (tau < -cap) cmd->tau_ff[i] -= (tau + cap);
    }
  }

  void rx_loop() {
    char payload[2048];
    size_t n = 0;
    while (running_) {
      std::string ch = bus_.receive(payload, sizeof(payload), &n);
      if (ch == kChannelPdTargets && n >= sizeof(PdTauTargets)) {
        PdTauTargets t;
        memcpy(&t, payload, sizeof(t));
        if (t.id == -1) {  // hard reset (reference lcm_agent.py:211-212)
          memset(&cmd_, 0, sizeof(cmd_));
          continue;
        }
        MotorCmd c;
        memcpy(c.q_des, t.q_des, sizeof(c.q_des));
        memcpy(c.qd_des, t.qd_des, sizeof(c.qd_des));
        memcpy(c.kp, t.kp, sizeof(c.kp));
        memcpy(c.kd, t.kd, sizeof(c.kd));
        memcpy(c.tau_ff, t.tau_ff, sizeof(c.tau_ff));
        cmd_ = c;
      }
    }
  }

  // one 500 Hz control tick (reference RobotControl, lcm_position.cpp:131-210)
  void tick() {
    LowState st;
    robot_->read_state(&st);

    LegControlData leg;
    memcpy(leg.q, st.q, sizeof(leg.q));
    memcpy(leg.qd, st.qd, sizeof(leg.qd));
    memcpy(leg.tau_est, st.tau, sizeof(leg.tau_est));
    bus_.publish(kChannelLegControl, &leg, sizeof(leg));

    StateEstimate se;
    memset(&se, 0, sizeof(se));
    memcpy(se.rpy, st.rpy, sizeof(se.rpy));
    memcpy(se.quat, st.quat, sizeof(se.quat));
    memcpy(se.omegaBody, st.gyro, sizeof(se.omegaBody));
    memcpy(se.aBody, st.acc, sizeof(se.aBody));
    memcpy(se.contact_estimate, st.foot_force, sizeof(se.contact_estimate));
    bus_.publish(kChannelStateEstimator, &se, sizeof(se));

    bus_.publish(kChannelRcCommand, &st.rc, sizeof(st.rc));

    MotorCmd cmd = cmd_;
    apply_safety(&cmd, st);
    robot_->write_cmd(cmd);
  }

  void run(long max_ticks) {
    std::thread rx(&Bridge::rx_loop, this);
    auto next = std::chrono::steady_clock::now();
    for (long t = 0; max_ticks < 0 || t < max_ticks; t++) {
      tick();
      next += std::chrono::microseconds(2000);
      std::this_thread::sleep_until(next);
    }
    running_ = false;
    rx.join();
  }

 private:
  RobotInterface *robot_;
  Bus bus_;
  MotorCmd cmd_;
  std::atomic<bool> running_;
};

}  // namespace wtw

int main(int argc, char **argv) {
  bool sim = false;
  long max_ticks = -1;
  for (int i = 1; i < argc; i++) {
    if (!strcmp(argv[i], "--sim")) sim = true;
    if (!strcmp(argv[i], "--ticks") && i + 1 < argc)
      max_ticks = atol(argv[++i]);
  }
  wtw::SimRobot sim_robot;
  wtw::UnitreeRobot real_robot;
  wtw::RobotInterface *robot =
      sim ? (wtw::RobotInterface *)&sim_robot : &real_robot;
  printf("wtw udp_bridge: %s mode, 500 Hz\n", sim ? "sim" : "robot");
  wtw::Bridge bridge(robot);
  bridge.run(max_ticks);
  return 0;
}
