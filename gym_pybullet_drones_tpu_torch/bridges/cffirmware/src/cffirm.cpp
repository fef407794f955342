// cffirm: C++ re-implementation of the Crazyflie-firmware subset used by the
// reference's CFAviary (envs/CFAviary.py:127-131, :401-416, :422-433,
// :498-606 — lpf2p biquads, the cascaded PID and Mellinger controllers, and
// the crtp high-level commander). Written from the public algorithm
// descriptions (Mellinger & Kumar 2011; Bitcraze firmware documentation and
// default tuning tables), NOT copied from the GPL firmware sources.
//
// Units follow the firmware conventions the reference relies on:
//   state.attitude        : degrees, legacy body frame (pitch INVERTED)
//   state.acc             : Gs, z without gravity ("+1 at hover")
//   sensorData.gyro       : deg/s (lpf2p-filtered by the caller)
//   sensorData.acc        : Gs, body frame
//   setpoint.attitude     : degrees;  setpoint.attitudeRate : deg/s
//   control.roll/pitch/yaw: torque commands in PWM counts (int16 range)
//   control.thrust        : collective thrust in PWM counts (0..65535)
//
// C ABI so Python binds via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Shared structs (layouts mirrored by ctypes.Structure on the Python side)
// ---------------------------------------------------------------------------

typedef struct { float x, y, z; } vec3;

typedef struct { uint32_t timestamp; float roll, pitch, yaw; } attitude_t;
typedef struct { uint32_t timestamp; float x, y, z, w; } quaternion_t;
typedef struct { uint32_t timestamp; float x, y, z; } point_t;

typedef struct {
  attitude_t attitude;            // deg; legacy frame (pitch inverted)
  quaternion_t attitudeQuaternion;
  point_t position;               // m
  point_t velocity;               // m/s
  point_t acc;                    // Gs, z without gravity
} state_t;

typedef struct {
  vec3 acc;                       // Gs
  vec3 gyro;                      // deg/s
  vec3 mag;                       // gauss (unused)
  uint64_t interruptTimestamp;    // us
} sensorData_t;

enum stab_mode_t { modeDisable = 0, modeAbs = 1, modeVelocity = 2 };

typedef struct {
  int32_t x, y, z, roll, pitch, yaw, quat;
} setpoint_mode_t;

typedef struct {
  uint32_t timestamp;
  attitude_t attitude;            // deg
  attitude_t attitudeRate;        // deg/s
  quaternion_t attitudeQuaternion;
  float thrust;                   // PWM counts when attitude-only
  point_t position;               // m
  point_t velocity;               // m/s
  point_t acceleration;           // m/s^2
  int32_t velocity_body;          // bool: velocity in body frame
  setpoint_mode_t mode;
} setpoint_t;

typedef struct {
  float roll, pitch, yaw;         // PWM-count torque commands
  float thrust;                   // PWM counts
} control_t;

// ---------------------------------------------------------------------------
// lpf2p: second-order Butterworth low-pass biquad (firmware filter.c API)
// ---------------------------------------------------------------------------

typedef struct {
  float a1, a2, b0, b1, b2;
  float delay1, delay2;
} lpf2pData;

void lpf2pInit(lpf2pData* f, float sample_freq, float cutoff_freq) {
  if (cutoff_freq <= 0.0f || sample_freq <= 0.0f) {
    std::memset(f, 0, sizeof(*f));
    f->b0 = 1.0f;  // pass-through
    return;
  }
  const float fr = sample_freq / cutoff_freq;
  const float ohm = std::tan(static_cast<float>(M_PI) / fr);
  const float c = 1.0f + 2.0f * std::cos(static_cast<float>(M_PI) / 4.0f) * ohm + ohm * ohm;
  f->b0 = ohm * ohm / c;
  f->b1 = 2.0f * f->b0;
  f->b2 = f->b0;
  f->a1 = 2.0f * (ohm * ohm - 1.0f) / c;
  f->a2 = (1.0f - 2.0f * std::cos(static_cast<float>(M_PI) / 4.0f) * ohm + ohm * ohm) / c;
  f->delay1 = 0.0f;
  f->delay2 = 0.0f;
}

float lpf2pApply(lpf2pData* f, float sample) {
  float delay0 = sample - f->delay1 * f->a1 - f->delay2 * f->a2;
  if (!std::isfinite(delay0)) delay0 = sample;  // firmware guards NaN inflow
  const float out = delay0 * f->b0 + f->delay1 * f->b1 + f->delay2 * f->b2;
  f->delay2 = f->delay1;
  f->delay1 = delay0;
  return out;
}

// ---------------------------------------------------------------------------
// Small math helpers
// ---------------------------------------------------------------------------

static inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
static inline float deg2rad(float d) { return d * 0.017453292519943295f; }
static inline float rad2deg(float r) { return r * 57.29577951308232f; }

static void quat_to_R(const quaternion_t& q, float R[3][3]) {
  const float x = q.x, y = q.y, z = q.z, w = q.w;
  R[0][0] = 1 - 2 * (y * y + z * z); R[0][1] = 2 * (x * y - w * z); R[0][2] = 2 * (x * z + w * y);
  R[1][0] = 2 * (x * y + w * z); R[1][1] = 1 - 2 * (x * x + z * z); R[1][2] = 2 * (y * z - w * x);
  R[2][0] = 2 * (x * z - w * y); R[2][1] = 2 * (y * z + w * x); R[2][2] = 1 - 2 * (x * x + y * y);
}

static inline vec3 vsub(vec3 a, vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline vec3 vcross(vec3 a, vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float vdot(vec3 a, vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline vec3 vnorm(vec3 a) {
  const float n = std::sqrt(vdot(a, a));
  if (n < 1e-9f) return {0, 0, 1};
  return {a.x / n, a.y / n, a.z / n};
}

// ---------------------------------------------------------------------------
// Generic PID element (firmware pid.c semantics: D on error, optional output
// low-pass omitted, integral clamp)
// ---------------------------------------------------------------------------

typedef struct {
  float kp, ki, kd;
  float integ, prev_err;
  float i_limit, out_limit;
  float dt;
  int initialized;
} pid_t_;

static void pid_init(pid_t_* p, float kp, float ki, float kd, float dt,
                     float i_limit, float out_limit) {
  p->kp = kp; p->ki = ki; p->kd = kd; p->dt = dt;
  p->i_limit = i_limit; p->out_limit = out_limit;
  p->integ = 0.0f; p->prev_err = 0.0f; p->initialized = 0;
}

static void pid_reset(pid_t_* p) { p->integ = 0; p->prev_err = 0; p->initialized = 0; }

static float pid_update(pid_t_* p, float err) {
  float deriv = p->initialized ? (err - p->prev_err) / p->dt : 0.0f;
  p->initialized = 1;
  p->prev_err = err;
  p->integ += err * p->dt;
  if (p->i_limit > 0) p->integ = clampf(p->integ, -p->i_limit, p->i_limit);
  float out = p->kp * err + p->ki * p->integ + p->kd * deriv;
  if (p->out_limit > 0) out = clampf(out, -p->out_limit, p->out_limit);
  return out;
}

// ---------------------------------------------------------------------------
// Cascaded PID controller (firmware controller_pid.c + position_controller_pid
// + attitude_pid_controller, default CF2 tuning). Rates: position loop gated
// by the caller via tick (CFAviary._step_controller:388-398 runs pos @100 Hz,
// att @500 Hz via _tick in {0: both, 1: none, 2: att only}).
// ---------------------------------------------------------------------------

#define ATTITUDE_RATE 500.0f
#define POSITION_RATE 100.0f

typedef struct {
  // position -> velocity setpoint
  pid_t_ px, py, pz;
  // velocity -> attitude / thrust
  pid_t_ vx, vy, vz;
  // attitude angle -> rate setpoint
  pid_t_ roll, pitch, yaw;
  // rate -> torque command
  pid_t_ rollRate, pitchRate, yawRate;
  float thrustBase, thrustScale, thrustMin;
  // carried between the 100 Hz position loop and 500 Hz attitude loop
  float att_roll_sp, att_pitch_sp, thrust_sp;
} pidc_t;

typedef struct {
  float mass, massThrust;
  float kp_xy, kd_xy, ki_xy, i_range_xy;
  float kp_z, kd_z, ki_z, i_range_z;
  float kR_xy, kw_xy, ki_m_xy, i_range_m_xy;
  float kR_z, kw_z, ki_m_z, i_range_m_z;
  float kd_omega_rp;
  vec3 i_error;       // position integral (m s)
  vec3 i_error_m;     // attitude integral
  vec3 prev_omega_err;
  lpf2pData err_d_lpf[2];  // D-term low-pass (roll, pitch)
} mel_t;

typedef struct {
  int active;            // a trajectory is defined (may be finished -> hold end)
  float t0, duration;
  vec3 p0, p1;
  float yaw0, yaw1;
  // current knowledge of vehicle state (TellState) and commander clock
  vec3 cur_pos;
  float cur_yaw;
  float now;
} hl_t;

// ---------------------------------------------------------------------------
// Firmware context: ALL controller/commander state lives here, so multiple
// CFAviary instances can coexist (process-global statics would silently
// corrupt concurrently-live envs). The
// legacy global-function API operates on the *active* context; a default
// context keeps single-env callers working unchanged.
// ---------------------------------------------------------------------------

typedef struct {
  pidc_t pidc;
  mel_t mel;
  hl_t hl;
} firm_ctx;

static firm_ctx g_default_ctx;
static firm_ctx* g_cur = &g_default_ctx;

firm_ctx* firmContextCreate(void) {
  firm_ctx* c = new firm_ctx();
  std::memset(c, 0, sizeof(*c));
  return c;
}

void firmContextDestroy(firm_ctx* c) {
  if (c == g_cur) g_cur = &g_default_ctx;
  if (c != &g_default_ctx) delete c;
}

void firmContextActivate(firm_ctx* c) { g_cur = c ? c : &g_default_ctx; }

firm_ctx* firmContextActive(void) { return g_cur; }

#define pidc (g_cur->pidc)
#define mel (g_cur->mel)
#define hl (g_cur->hl)

void controllerPidInit(void) {
  const float pdt = 1.0f / POSITION_RATE;
  const float adt = 1.0f / ATTITUDE_RATE;
  // Default CF2 gain table (Bitcraze documented defaults)
  pid_init(&pidc.px, 2.0f, 0.0f, 0.0f, pdt, 5000.0f, 1.1f);   // m -> m/s, xy vel limit 1.1
  pid_init(&pidc.py, 2.0f, 0.0f, 0.0f, pdt, 5000.0f, 1.1f);
  pid_init(&pidc.pz, 2.0f, 0.5f, 0.0f, pdt, 5000.0f, 1.1f);
  pid_init(&pidc.vx, 25.0f, 1.0f, 0.0f, pdt, 5000.0f, 20.0f); // m/s -> deg, rp limit 20
  pid_init(&pidc.vy, 25.0f, 1.0f, 0.0f, pdt, 5000.0f, 20.0f);
  pid_init(&pidc.vz, 25.0f, 15.0f, 0.0f, pdt, 5000.0f, 0.0f);
  pid_init(&pidc.roll, 6.0f, 3.0f, 0.0f, adt, 20.0f, 0.0f);   // deg -> deg/s
  pid_init(&pidc.pitch, 6.0f, 3.0f, 0.0f, adt, 20.0f, 0.0f);
  pid_init(&pidc.yaw, 6.0f, 1.0f, 0.35f, adt, 360.0f, 0.0f);
  pid_init(&pidc.rollRate, 250.0f, 500.0f, 2.5f, adt, 33.3f, 0.0f);  // deg/s -> pwm
  pid_init(&pidc.pitchRate, 250.0f, 500.0f, 2.5f, adt, 33.3f, 0.0f);
  pid_init(&pidc.yawRate, 120.0f, 16.7f, 0.0f, adt, 166.7f, 0.0f);
  pidc.thrustBase = 36000.0f;
  pidc.thrustScale = 1000.0f;
  pidc.thrustMin = 20000.0f;
  pidc.att_roll_sp = 0; pidc.att_pitch_sp = 0; pidc.thrust_sp = 0;
}

int controllerPidTest(void) { return 1; }

void controllerPid(control_t* control, const setpoint_t* setpoint,
                   const sensorData_t* sensors, const state_t* state,
                   uint32_t tick) {
  // tick semantics (CFAviary.py:388-398): 0 = position + attitude,
  // 2 = attitude only, 1 = hold previous outputs.
  const int run_pos = (tick == 0);
  const int run_att = (tick == 0 || tick == 2);

  if (run_pos) {
    float vx_sp, vy_sp, vz_sp;
    if (setpoint->mode.x == modeAbs) {
      vx_sp = pid_update(&pidc.px, setpoint->position.x - state->position.x)
              + setpoint->velocity.x;
      vy_sp = pid_update(&pidc.py, setpoint->position.y - state->position.y)
              + setpoint->velocity.y;
    } else {
      vx_sp = setpoint->velocity.x;
      vy_sp = setpoint->velocity.y;
    }
    if (setpoint->mode.z == modeAbs) {
      vz_sp = pid_update(&pidc.pz, setpoint->position.z - state->position.z)
              + setpoint->velocity.z;
    } else {
      vz_sp = setpoint->velocity.z;
    }
    // Velocity loop: world-frame accel demand rotated into body yaw
    const float rawPitch = pid_update(&pidc.vx, vx_sp - state->velocity.x);
    const float rawRoll = pid_update(&pidc.vy, vy_sp - state->velocity.y);
    const float yaw_rad = deg2rad(state->attitude.yaw);
    pidc.att_pitch_sp = -(rawPitch * std::cos(yaw_rad) + rawRoll * std::sin(yaw_rad));
    pidc.att_roll_sp = -(rawRoll * std::cos(yaw_rad) - rawPitch * std::sin(yaw_rad));
    pidc.att_pitch_sp = clampf(pidc.att_pitch_sp, -20.0f, 20.0f);
    pidc.att_roll_sp = clampf(pidc.att_roll_sp, -20.0f, 20.0f);
    const float thrustRaw = pid_update(&pidc.vz, vz_sp - state->velocity.z);
    pidc.thrust_sp = clampf(thrustRaw * pidc.thrustScale + pidc.thrustBase,
                            pidc.thrustMin, 65535.0f);
  }

  if (run_att) {
    float roll_sp = pidc.att_roll_sp, pitch_sp = pidc.att_pitch_sp;
    float yaw_sp_rate;
    if (setpoint->mode.z == modeDisable && setpoint->mode.x == modeDisable) {
      // Pure attitude setpoint flight
      roll_sp = setpoint->attitude.roll;
      pitch_sp = setpoint->attitude.pitch;
      pidc.thrust_sp = setpoint->thrust;
    }
    // Angle loop — both setpoint and state attitude are in the legacy frame
    // (pitch inverted), so errors subtract directly.
    const float roll_rate_sp = pid_update(&pidc.roll, roll_sp - state->attitude.roll);
    const float pitch_rate_sp = pid_update(&pidc.pitch, pitch_sp - state->attitude.pitch);
    float yaw_err = setpoint->attitude.yaw - state->attitude.yaw;
    while (yaw_err > 180.0f) yaw_err -= 360.0f;
    while (yaw_err < -180.0f) yaw_err += 360.0f;
    yaw_sp_rate = (setpoint->mode.yaw == modeVelocity)
                      ? setpoint->attitudeRate.yaw
                      : pid_update(&pidc.yaw, yaw_err);
    // Rate loop against the (filtered) gyro, deg/s
    control->roll = clampf(pid_update(&pidc.rollRate, roll_rate_sp - sensors->gyro.x),
                           -32000.0f, 32000.0f);
    control->pitch = clampf(pid_update(&pidc.pitchRate, pitch_rate_sp - (-sensors->gyro.y)),
                            -32000.0f, 32000.0f);
    control->yaw = clampf(-pid_update(&pidc.yawRate, yaw_sp_rate - sensors->gyro.z),
                          -32000.0f, 32000.0f);
    control->thrust = pidc.thrust_sp;
  }

  // Disarmed / zero-thrust branch (controller_pid.c semantics): no torque
  // outputs and all integrators reset, so nothing winds up while the vehicle
  // sits on the ground waiting for a setpoint.
  if (control->thrust == 0.0f) {
    control->roll = 0.0f;
    control->pitch = 0.0f;
    control->yaw = 0.0f;
    pid_reset(&pidc.px); pid_reset(&pidc.py); pid_reset(&pidc.pz);
    pid_reset(&pidc.vx); pid_reset(&pidc.vy); pid_reset(&pidc.vz);
    pid_reset(&pidc.roll); pid_reset(&pidc.pitch); pid_reset(&pidc.yaw);
    pid_reset(&pidc.rollRate); pid_reset(&pidc.pitchRate); pid_reset(&pidc.yawRate);
    pidc.att_roll_sp = 0.0f;
    pidc.att_pitch_sp = 0.0f;
    pidc.thrust_sp = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Mellinger controller (Mellinger & Kumar 2011 geometric tracking control,
// firmware default tuning; runs at 500 Hz)
// ---------------------------------------------------------------------------

void controllerMellingerInit(void) {
  mel.mass = 0.032f;          // firmware g_vehicleMass (CF2 + deck)
  mel.massThrust = 132000.0f; // thrust (N) -> PWM counts
  mel.kp_xy = 0.4f; mel.kd_xy = 0.2f; mel.ki_xy = 0.05f; mel.i_range_xy = 2.0f;
  mel.kp_z = 1.25f; mel.kd_z = 0.4f; mel.ki_z = 0.05f; mel.i_range_z = 0.4f;
  mel.kR_xy = 70000.0f; mel.kw_xy = 20000.0f; mel.ki_m_xy = 0.0f; mel.i_range_m_xy = 1.0f;
  mel.kR_z = 60000.0f; mel.kw_z = 12000.0f; mel.ki_m_z = 500.0f; mel.i_range_m_z = 1500.0f;
  // Firmware default 200. The simulation feeds finite-differenced Euler rates
  // (CFAviary.py:215-217) whose second derivative is noise; raw, that made the
  // attitude loop limit-cycle at +-0.27 rad. The firmware's
  // own answer is low-passing the D term — err_d runs through a 2nd-order
  // Butterworth (30 Hz, the same cutoff the accelerometer path uses), which
  // kills the finite-difference noise while keeping the damping. Escape
  // hatch: controllerMellingerSetKdOmegaRP(0) disables the term entirely.
  mel.kd_omega_rp = 200.0f;
  mel.i_error = {0, 0, 0};
  mel.i_error_m = {0, 0, 0};
  mel.prev_omega_err = {0, 0, 0};
  lpf2pInit(&mel.err_d_lpf[0], ATTITUDE_RATE, 30.0f);
  lpf2pInit(&mel.err_d_lpf[1], ATTITUDE_RATE, 30.0f);
}

int controllerMellingerTest(void) { return 1; }

void controllerMellingerSetKdOmegaRP(float kd) { mel.kd_omega_rp = kd; }

void controllerMellinger(control_t* control, const setpoint_t* setpoint,
                         const sensorData_t* sensors, const state_t* state,
                         uint32_t tick) {
  const float dt = 1.0f / ATTITUDE_RATE;
  if (tick == 1) return;  // neither loop scheduled this tick

  const float GRAV = 9.81f;
  vec3 target_thrust;
  vec3 r_error = {0, 0, 0}, v_error = {0, 0, 0};
  float desired_yaw_rad = 0.0f;

  if (setpoint->mode.x == modeAbs) {
    r_error = {setpoint->position.x - state->position.x,
               setpoint->position.y - state->position.y,
               setpoint->position.z - state->position.z};
    v_error = {setpoint->velocity.x - state->velocity.x,
               setpoint->velocity.y - state->velocity.y,
               setpoint->velocity.z - state->velocity.z};
    mel.i_error.x = clampf(mel.i_error.x + r_error.x * dt, -mel.i_range_xy, mel.i_range_xy);
    mel.i_error.y = clampf(mel.i_error.y + r_error.y * dt, -mel.i_range_xy, mel.i_range_xy);
    mel.i_error.z = clampf(mel.i_error.z + r_error.z * dt, -mel.i_range_z, mel.i_range_z);
    target_thrust.x = mel.mass * setpoint->acceleration.x
                      + mel.kp_xy * r_error.x + mel.kd_xy * v_error.x
                      + mel.ki_xy * mel.i_error.x;
    target_thrust.y = mel.mass * setpoint->acceleration.y
                      + mel.kp_xy * r_error.y + mel.kd_xy * v_error.y
                      + mel.ki_xy * mel.i_error.y;
    target_thrust.z = mel.mass * (setpoint->acceleration.z + GRAV)
                      + mel.kp_z * r_error.z + mel.kd_z * v_error.z
                      + mel.ki_z * mel.i_error.z;
    if (setpoint->mode.quat == modeAbs) {
      // yaw from the setpoint quaternion (full-state command)
      const quaternion_t& q = setpoint->attitudeQuaternion;
      desired_yaw_rad = std::atan2(2.0f * (q.w * q.z + q.x * q.y),
                                   1.0f - 2.0f * (q.y * q.y + q.z * q.z));
    } else {
      desired_yaw_rad = deg2rad(setpoint->attitude.yaw);
    }
  } else {
    // Attitude-only flight: thrust passthrough, attitude from setpoint
    target_thrust = {0, 0, 1};
    desired_yaw_rad = deg2rad(setpoint->attitude.yaw);
  }

  float R[3][3];
  quat_to_R(state->attitudeQuaternion, R);
  const vec3 z_axis = {R[0][2], R[1][2], R[2][2]};
  float current_thrust = vdot(target_thrust, z_axis);

  const vec3 z_axis_desired = vnorm(target_thrust);
  const vec3 x_c_des = {std::cos(desired_yaw_rad), std::sin(desired_yaw_rad), 0};
  const vec3 y_axis_desired = vnorm(vcross(z_axis_desired, x_c_des));
  const vec3 x_axis_desired = vcross(y_axis_desired, z_axis_desired);

  // eR = (Rdes^T R - R^T Rdes)^vee with the firmware's layout: NO 1/2 factor,
  // and the y component negated for the legacy inverted-pitch output frame.
  const vec3 xb = {R[0][0], R[1][0], R[2][0]};
  const vec3 yb = {R[0][1], R[1][1], R[2][1]};
  vec3 eR;
  eR.x = vdot(yb, z_axis_desired) - vdot(z_axis, y_axis_desired);
  eR.y = -(vdot(z_axis, x_axis_desired) - vdot(xb, z_axis_desired));
  eR.z = vdot(xb, y_axis_desired) - vdot(yb, x_axis_desired);

  // Angular velocity error (gyro in deg/s -> rad/s); desired rates from setpoint
  const vec3 omega = {deg2rad(sensors->gyro.x), deg2rad(sensors->gyro.y),
                      deg2rad(sensors->gyro.z)};
  const vec3 omega_des = {deg2rad(setpoint->attitudeRate.roll),
                          deg2rad(setpoint->attitudeRate.pitch),
                          deg2rad(setpoint->attitudeRate.yaw)};
  vec3 ew = vsub(omega_des, omega);
  ew.y = -ew.y;

  vec3 err_d = {(ew.x - mel.prev_omega_err.x) / dt,
                (ew.y - mel.prev_omega_err.y) / dt,
                (ew.z - mel.prev_omega_err.z) / dt};
  mel.prev_omega_err = ew;
  // D-term low-pass (see controllerMellingerInit note); yaw has no D term.
  err_d.x = lpf2pApply(&mel.err_d_lpf[0], err_d.x);
  err_d.y = lpf2pApply(&mel.err_d_lpf[1], err_d.y);

  mel.i_error_m.x = clampf(mel.i_error_m.x - eR.x * dt, -mel.i_range_m_xy, mel.i_range_m_xy);
  mel.i_error_m.y = clampf(mel.i_error_m.y - eR.y * dt, -mel.i_range_m_xy, mel.i_range_m_xy);
  mel.i_error_m.z = clampf(mel.i_error_m.z - eR.z * dt, -mel.i_range_m_z, mel.i_range_m_z);

  const float Mx = -mel.kR_xy * eR.x + mel.kw_xy * ew.x + mel.ki_m_xy * mel.i_error_m.x
                   + mel.kd_omega_rp * err_d.x;
  const float My = -mel.kR_xy * eR.y + mel.kw_xy * ew.y + mel.ki_m_xy * mel.i_error_m.y
                   + mel.kd_omega_rp * err_d.y;
  const float Mz = -mel.kR_z * eR.z + mel.kw_z * ew.z + mel.ki_m_z * mel.i_error_m.z;

  if (setpoint->mode.z == modeDisable) {
    control->thrust = setpoint->thrust;
  } else {
    control->thrust = mel.massThrust * current_thrust;
  }
  if (control->thrust > 0) {
    control->roll = clampf(Mx, -32000.0f, 32000.0f);
    control->pitch = clampf(My, -32000.0f, 32000.0f);
    control->yaw = clampf(-Mz, -32000.0f, 32000.0f);
  } else {
    control->roll = 0; control->pitch = 0; control->yaw = 0;
    // Reset integrals when motors idle (firmware behavior on thrust cut)
    mel.i_error = {0, 0, 0};
    mel.i_error_m = {0, 0, 0};
    mel.prev_omega_err = {0, 0, 0};
  }
}

// ---------------------------------------------------------------------------
// crtp high-level commander: rest-to-rest septic (7th-order) trajectories for
// takeoff / land / goto, evaluated into full-state setpoints
// (firmware crtp_commander_high_level.c + planner.c capability surface).
// ---------------------------------------------------------------------------

void crtpCommanderHighLevelInit(void) {
  std::memset(&hl, 0, sizeof(hl));
}

void crtpCommanderHighLevelTellState(const state_t* state) {
  hl.cur_pos = {state->position.x, state->position.y, state->position.z};
  hl.cur_yaw = deg2rad(state->attitude.yaw);
}

void crtpCommanderHighLevelUpdateTime(float t) { hl.now = t; }

int crtpCommanderHighLevelIsTrajectoryFinished(void) {
  return !hl.active || (hl.now - hl.t0) >= hl.duration;
}

void crtpCommanderHighLevelStop(void) { hl.active = 0; }

static void hl_plan(vec3 p1, float yaw1, float duration) {
  hl.p0 = hl.cur_pos;
  hl.p1 = p1;
  hl.yaw0 = hl.cur_yaw;
  hl.yaw1 = yaw1;
  hl.t0 = hl.now;
  hl.duration = duration > 1e-3f ? duration : 1e-3f;
  hl.active = 1;
}

void crtpCommanderHighLevelTakeoff(float height, float duration) {
  hl_plan({hl.cur_pos.x, hl.cur_pos.y, height}, hl.cur_yaw, duration);
}

void crtpCommanderHighLevelTakeoffYaw(float height, float duration, float yaw) {
  hl_plan({hl.cur_pos.x, hl.cur_pos.y, height}, yaw, duration);
}

void crtpCommanderHighLevelLand(float height, float duration) {
  hl_plan({hl.cur_pos.x, hl.cur_pos.y, height}, hl.cur_yaw, duration);
}

void crtpCommanderHighLevelLandYaw(float height, float duration, float yaw) {
  hl_plan({hl.cur_pos.x, hl.cur_pos.y, height}, yaw, duration);
}

static float hl_vel_duration(float dist, float vel) {
  const float v = vel > 0.05f ? vel : 0.05f;
  return dist / v;
}

void crtpCommanderHighLevelTakeoffWithVelocity(float height, float vel, int relative) {
  const float target = relative ? hl.cur_pos.z + height : height;
  hl_plan({hl.cur_pos.x, hl.cur_pos.y, target}, hl.cur_yaw,
          hl_vel_duration(std::fabs(target - hl.cur_pos.z), vel));
}

void crtpCommanderHighLevelLandWithVelocity(float height, float vel, int relative) {
  const float target = relative ? hl.cur_pos.z - height : height;
  hl_plan({hl.cur_pos.x, hl.cur_pos.y, target}, hl.cur_yaw,
          hl_vel_duration(std::fabs(hl.cur_pos.z - target), vel));
}

void crtpCommanderHighLevelGoTo(float x, float y, float z, float yaw,
                                float duration, int relative) {
  vec3 p1 = relative ? vec3{hl.cur_pos.x + x, hl.cur_pos.y + y, hl.cur_pos.z + z}
                     : vec3{x, y, z};
  const float yaw1 = relative ? hl.cur_yaw + yaw : yaw;
  hl_plan(p1, yaw1, duration);
}

// Septic rest-to-rest blend: s(0)=0, s(1)=1, s',s'',s''' = 0 at both ends.
static void septic(float tau, float* s, float* ds, float* dds) {
  const float t2 = tau * tau, t3 = t2 * tau, t4 = t3 * tau, t5 = t4 * tau,
              t6 = t5 * tau, t7 = t6 * tau;
  *s = 35.0f * t4 - 84.0f * t5 + 70.0f * t6 - 20.0f * t7;
  *ds = 140.0f * t3 - 420.0f * t4 + 420.0f * t5 - 140.0f * t6;
  *dds = 420.0f * t2 - 1680.0f * t3 + 2100.0f * t4 - 840.0f * t5;
}

void crtpCommanderHighLevelGetSetpoint(setpoint_t* sp, const state_t* state) {
  (void)state;
  if (!hl.active) return;
  float tau = (hl.now - hl.t0) / hl.duration;
  tau = clampf(tau, 0.0f, 1.0f);
  float s, ds, dds;
  septic(tau, &s, &ds, &dds);
  const float inv_T = 1.0f / hl.duration;
  const vec3 d = vsub(hl.p1, hl.p0);

  sp->position = {0, hl.p0.x + d.x * s, hl.p0.y + d.y * s, hl.p0.z + d.z * s};
  sp->velocity = {0, d.x * ds * inv_T, d.y * ds * inv_T, d.z * ds * inv_T};
  sp->acceleration = {0, d.x * dds * inv_T * inv_T, d.y * dds * inv_T * inv_T,
                      d.z * dds * inv_T * inv_T};

  const float yaw = hl.yaw0 + (hl.yaw1 - hl.yaw0) * s;
  const float yaw_rate = (hl.yaw1 - hl.yaw0) * ds * inv_T;
  sp->attitude.roll = 0;
  sp->attitude.pitch = 0;
  sp->attitude.yaw = rad2deg(yaw);
  sp->attitudeRate.roll = 0;
  sp->attitudeRate.pitch = 0;
  sp->attitudeRate.yaw = rad2deg(yaw_rate);
  sp->attitudeQuaternion.x = 0;
  sp->attitudeQuaternion.y = 0;
  sp->attitudeQuaternion.z = std::sin(yaw * 0.5f);
  sp->attitudeQuaternion.w = std::cos(yaw * 0.5f);

  sp->mode.x = modeAbs; sp->mode.y = modeAbs; sp->mode.z = modeAbs;
  sp->mode.quat = modeAbs;
  sp->mode.roll = modeDisable; sp->mode.pitch = modeDisable;
  sp->mode.yaw = modeDisable;
}

}  // extern "C"
